"""Serve tier of the port: engine, scheduler, page pool and reuse indices,
sessions, config, sampling."""
from repro_torch.serve.cache import PageDedupIndex, PagePool, PrefixTrie
from repro_torch.serve.config import EngineConfig, auto_page_size
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.sampling import GREEDY, SamplingParams
from repro_torch.serve.scheduler import DegradeLadder, Request, Scheduler
from repro_torch.serve.sessions import Session, SessionStore

__all__ = ["EngineConfig", "auto_page_size", "ServeEngine", "GREEDY",
           "SamplingParams", "Request", "Scheduler", "DegradeLadder",
           "PagePool", "PrefixTrie", "PageDedupIndex", "Session",
           "SessionStore"]
