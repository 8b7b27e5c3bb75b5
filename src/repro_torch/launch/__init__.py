"""launch entry points of the PyTorch/CUDA port (mirrors repro.launch)."""
