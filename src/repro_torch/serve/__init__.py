"""Serve tier of the port: engine, scheduler, page pool, config, sampling."""
from repro_torch.serve.config import EngineConfig, auto_page_size
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.sampling import GREEDY, SamplingParams
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["EngineConfig", "auto_page_size", "ServeEngine", "GREEDY",
           "SamplingParams", "Request", "Scheduler"]
