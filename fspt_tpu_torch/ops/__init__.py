"""Device kernels of the port: hand-written CUDA for Hopper behind plain
PyTorch wrappers, each with its plain PyTorch version beside it."""
