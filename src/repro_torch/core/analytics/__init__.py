"""Federated analytics: the bit-vote protocol, normalization factors and
label balancing (port of ``repro.core.analytics``)."""
