"""PyTorch/CUDA port of the federated aggregation engine (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its layout
and names and imports nothing of it (nor JAX).  Entry points run on the GPU
(``device="cuda"``) unless the caller passes ``device="cpu"``; the
hand-written Hopper kernels under ``repro_torch.kernels`` are launched for
CUDA tensors and replaced by their plain PyTorch versions for CPU tensors.
"""
