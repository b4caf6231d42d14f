"""Train state, train step and loop (counterpart of ``repro.train``)."""
