"""Device ops of the port: hand-written CUDA kernels with their plain
PyTorch versions, and the plain torch ops around them."""

from wormhole_tpu_torch.ops.hashing import cityhash64, reverse_bytes_u64  # noqa: F401
