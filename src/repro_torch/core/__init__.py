"""Carry theory and accumulator planning (copies of ``repro.core`` modules)."""
