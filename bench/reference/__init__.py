"""Plain PyTorch references: nothing of the system under test."""
