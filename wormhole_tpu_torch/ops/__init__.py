"""Device ops of the port: hand-written CUDA kernels with their plain
PyTorch versions, and the plain torch ops around them."""
