"""Deterministic synthetic data (counterpart of ``repro.data``)."""
