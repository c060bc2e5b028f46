"""Build, load and count the port's hand-written CUDA kernels.

Each source under ``wormhole_tpu_torch/csrc/`` compiles with ``nvcc``
into its own shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries are
built at first use into ``build/wormhole_tpu_torch/`` beside the package,
named by a hash of the source and flags, so an edited source rebuilds and
concurrent builds never see a half-written file. ``build()`` compiles
several sources at once, one ``nvcc`` each.

Nothing here runs at import: the CPU tests import every module of the
port on a machine with no ``nvcc``.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper
adds one right after its kernel launched, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "wormhole_tpu_torch"
SOURCES = ("coo_kernels", "fused_update")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = {"coo_spmv": 0, "coo_spmv_t": 0, "tile_gather": 0,
            "scatter_update": 0, "row_tile_gather": 0,
            "fm_push_contrib": 0, "v_scatter_update": 0}

_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)
_SIGNATURES = {
    "coo_kernels": {
        "wh_coo_spmv": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _P],
        "wh_coo_spmv_t": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _P],
        "wh_tile_gather": [_P, _P, _P, _I64, _I64, _I, _P],
        "wh_fm_push_contrib": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                               _I, _I, _I, _P],
    },
    "fused_update": {
        "wh_scatter_update": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I64, _I64, _F, _F, _F, _F, _F, _P, _P],
        "wh_row_tile_gather": [_P, _P, _P, _I64, _I64, _I, _I, _P],
        "wh_v_scatter_update": [_P, _P, _P, _P, _P, _I64, _I64, _I, _I,
                                _F, _F, _F, _P],
    },
}
_ERROR_STRING = {"coo_kernels": "wh_coo_error_string",
                 "fused_update": "wh_fused_error_string"}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return path


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named source that has no library yet, all at once
    (one nvcc process each). Returns the wall seconds of each build that
    ran; raises with nvcc's output if one fails."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, time.perf_counter())
    secs, failed = {}, []
    for n, (p, tmp, t0) in procs.items():
        out, _ = p.communicate()
        secs[n] = time.perf_counter() - t0
        if p.returncode != 0:
            failed.append(f"{n}.cu:\n{out}")
        else:
            os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return secs


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    with _lock:
        if name not in _libs:
            build([name])
            so = ctypes.CDLL(str(lib_path(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(so, fn).argtypes = argtypes
                getattr(so, fn).restype = ctypes.c_int
            err = getattr(so, _ERROR_STRING[name])
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = so
        return _libs[name]


def check(name: str, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = getattr(lib(name), _ERROR_STRING[name])(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def require(what: str, device: torch.device, **tensors) -> None:
    """Check what a kernel takes: every tensor contiguous, on the same
    CUDA device, int32 or float32 as its name's role says."""
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, "
                             f"expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        want = torch.int32 if name in _INT_ARGS else torch.float32
        if t.dtype != want:
            raise ValueError(f"{what}: {name} is {t.dtype}, expected {want}")


_INT_ARGS = {"sidx", "sseg", "uniq", "idx", "seg"}
