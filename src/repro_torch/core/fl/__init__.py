"""core.fl of the PyTorch/CUDA port (mirrors repro.core.fl)."""
