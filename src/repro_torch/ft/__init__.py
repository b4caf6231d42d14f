"""Fault-tolerance policies of the train loop (counterpart of ``repro.ft``)."""
