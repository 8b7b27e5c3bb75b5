"""kernels of the PyTorch/CUDA port (mirrors repro.kernels)."""
