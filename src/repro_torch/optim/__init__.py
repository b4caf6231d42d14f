"""Optimizer layer of the port: AdamW, LR schedules, gradient accumulation."""
