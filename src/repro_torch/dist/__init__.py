"""The shared radix-4 reduction plan (copy of ``repro.dist.plan``)."""
