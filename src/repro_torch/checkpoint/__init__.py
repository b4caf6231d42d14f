"""Checkpoints of the train state (counterpart of ``repro.checkpoint``)."""
