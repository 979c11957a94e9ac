"""Inference: decoder KV caches, the continuous-batching slot engine and
the paged engine."""

from flasht5_tpu_torch.inference.engine import (EngineConfig, InferenceEngine,
                                                Request)
from flasht5_tpu_torch.inference.paged_engine import (PagedEngineConfig,
                                                      PagedInferenceEngine)

__all__ = ["EngineConfig", "InferenceEngine", "PagedEngineConfig",
           "PagedInferenceEngine", "Request"]
