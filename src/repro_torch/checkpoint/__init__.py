"""Checkpoints of parameter trees (port of ``repro.checkpoint``)."""
