"""Device-side primitives (PyTorch), with their CUDA kernels."""
