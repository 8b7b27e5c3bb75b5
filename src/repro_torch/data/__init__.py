"""Synthetic federated datasets (copied from the JAX package)."""
