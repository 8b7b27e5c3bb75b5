"""configs of the PyTorch/CUDA port (mirrors repro.configs)."""
