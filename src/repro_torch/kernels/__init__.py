"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``ref.py``).  A wrapper runs the plain version for a tensor on
the CPU and launches its kernel for a tensor on a CUDA device."""
