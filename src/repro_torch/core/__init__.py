"""core of the PyTorch/CUDA port (mirrors repro.core)."""
