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
