"""Paper-faithful model: small dense-feature MLP binary classifier.

The paper trains binary classifiers on dense features only ("we rely solely
upon dense features to even further reduce the chance of memorizing individual
data entries"), with width / depth / lr tuned server-side.  This config class
describes that model; ``repro.models.mlp`` builds it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MLPConfig:
    name: str = "dcp-binary-classifier"
    num_features: int = 32
    hidden_dims: Tuple[int, ...] = (64, 32)
    activation: str = "relu"  # relu | tanh
    dropout: float = 0.0
    citation: str = "Stojkovic et al. 2022 (this paper), §Model"


CONFIG = MLPConfig()


def reduced() -> MLPConfig:
    return MLPConfig(name="dcp-binary-classifier-reduced", num_features=8, hidden_dims=(16,))
