"""Inference: decoder KV caches and the continuous-batching slot engine."""

from flasht5_tpu_torch.inference.engine import (EngineConfig, InferenceEngine,
                                                Request)

__all__ = ["EngineConfig", "InferenceEngine", "Request"]
