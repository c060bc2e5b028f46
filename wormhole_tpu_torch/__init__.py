"""wormhole_tpu_torch: the PyTorch/CUDA port of wormhole_tpu.

A second package beside the JAX one, for one NVIDIA H100. It keeps the
JAX package's module names, public signatures and conf keys, imports
nothing from it, and replaces each Pallas TPU kernel on its path with a
CUDA kernel written by hand (``csrc/``), held against a plain PyTorch
version of itself. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on CPU tensors the kernel wrappers run the plain
versions.
"""

__version__ = "0.1.0"

import os as _os


def _install_stackdump() -> None:
    """WORMHOLE_STACKDUMP=1: dump all-thread Python stacks to stderr on
    SIGUSR1 — the way to see where a launcher-spawned role process is
    stuck on a machine without gdb or py-spy."""
    if _os.environ.get("WORMHOLE_STACKDUMP") != "1":
        return
    try:
        import faulthandler
        import signal

        faulthandler.register(signal.SIGUSR1, all_threads=True)
    except (ImportError, AttributeError, ValueError):
        pass  # non-main thread / platform without SIGUSR1


_install_stackdump()


def _arm_wormsan() -> bool:
    """WH_SAN=1: install the port's runtime concurrency sanitizer
    (wormhole_tpu_torch/wormsan) before any submodule import creates a
    lock, so every ``threading.Lock``/``RLock`` made after it is wrapped.
    The shared-state model is loaded first (it needs tools/wormlint from
    the repo root); each model class is instrumented when its module is
    imported, so arming imports nothing the process would not."""
    if _os.environ.get("WH_SAN") != "1":
        return False
    import sys as _sys

    try:
        from wormhole_tpu_torch import wormsan

        model = wormsan.load_model()
    except ImportError as e:
        _sys.stderr.write(f"[wormsan] WH_SAN=1 but the sanitizer cannot "
                          f"load its model ({e}; run from the repo root): "
                          f"WH_SAN is off in this process\n")
        return False
    wormsan.install(instrument=False)
    wormsan.instrument_classes(model)
    return True


_WORMSAN_ARMED = _arm_wormsan()
