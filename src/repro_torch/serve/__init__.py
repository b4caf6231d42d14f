"""Serve tier of the port: engine, scheduler, page pool and reuse indices,
sessions, speculative drafting and acceptance, config, sampling and its
threefry PRNG."""
from repro_torch.serve.cache import (PageDedupIndex, PagePool, PrefixTrie,
                                     state_zeros)
from repro_torch.serve.config import (KV_DTYPES, SPEC_DRAFTERS,
                                      SPEC_MODES, EngineConfig,
                                      add_cli_args, auto_page_size,
                                      config_from_args, knob_table_md)
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.sampling import GREEDY, SamplingParams, sample_tokens
from repro_torch.serve.scheduler import DegradeLadder, Request, Scheduler
from repro_torch.serve.sessions import Session, SessionStore
from repro_torch.serve.spec import (DraftHeadDrafter, NGramTreeDrafter,
                                    PromptLookupDrafter, SuffixCache,
                                    TreeDraft, accept_path, accept_tokens,
                                    expected_tokens_chain,
                                    expected_tokens_tree,
                                    per_candidate_accept, pick_shape,
                                    propose_draft, tree_depth)

__all__ = ["EngineConfig", "KV_DTYPES", "SPEC_MODES", "SPEC_DRAFTERS",
           "auto_page_size", "knob_table_md", "add_cli_args",
           "config_from_args", "state_zeros", "ServeEngine", "GREEDY", "SamplingParams",
           "sample_tokens", "Request", "Scheduler",
           "DegradeLadder", "PagePool", "PrefixTrie", "PageDedupIndex",
           "Session", "SessionStore", "PromptLookupDrafter",
           "propose_draft", "accept_tokens", "SuffixCache", "TreeDraft",
           "accept_path", "NGramTreeDrafter", "DraftHeadDrafter",
           "expected_tokens_chain", "expected_tokens_tree", "pick_shape",
           "per_candidate_accept", "tree_depth"]
