"""Hand-written CUDA kernels of the port; see ops.py for the public wrappers."""
