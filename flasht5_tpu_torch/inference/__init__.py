"""Inference: the decode state and KV-cached decode steps, greedy and
sampled generation, beam search, speculative decoding, the continuous-
batching slot engine and the paged engine, and both engines across ranks
(`sharded_engine`, `sharded_paged_engine`)."""

from flasht5_tpu_torch.inference.beam_search import beam_generate
from flasht5_tpu_torch.inference.engine import (EngineConfig, InferenceEngine,
                                                Request)
from flasht5_tpu_torch.inference.generate import generate
from flasht5_tpu_torch.inference.kv_cache import (DecodeState, decode_step,
                                                  decode_window_step,
                                                  init_decode_state)
from flasht5_tpu_torch.inference.paged_engine import (PagedEngineConfig,
                                                      PagedInferenceEngine)
from flasht5_tpu_torch.inference.sharded_engine import (ShardedEngine,
                                                        make_serving_mesh)
from flasht5_tpu_torch.inference.sharded_paged_engine import (
    ShardedPagedEngine)
from flasht5_tpu_torch.inference.speculative import speculative_generate

__all__ = ["DecodeState", "EngineConfig", "InferenceEngine",
           "PagedEngineConfig", "PagedInferenceEngine", "Request",
           "ShardedEngine", "ShardedPagedEngine", "beam_generate",
           "decode_step", "decode_window_step", "generate",
           "init_decode_state", "make_serving_mesh", "speculative_generate"]
