"""models of the PyTorch/CUDA port (mirrors repro.models)."""
