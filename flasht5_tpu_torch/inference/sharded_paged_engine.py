"""Serving across ranks with paged KV: the paged engine on a ("data",
"tensor") mesh.

The PyTorch counterpart of `flasht5_tpu/inference/sharded_paged_engine.py`,
on the collectives of `sharded_engine.py` (weights in the Megatron layout,
quantized leaves included; the prefill's rows over "data" and its cross K/V
gathered; the window's outputs gathered over "data"; the row-split
products reduced and the next token taken over "tensor"):

- page pools: each data rank holds an independent pool of `num_pages`
  pages (the config's pages per data shard) plus its own trash page, over
  its H / t heads;
- host allocator (`PagedState(..., shards=data).pages`, JAX's
  `ShardedPagedState`): one free list per data rank,
  and every rank keeps all of them, so their admissions and deferrals
  agree; a slot's page-table row holds LOCAL page ids of the pool of the
  rank that owns the slot, and a rank ships only its own slots' rows to its
  card;
- the window: each rank runs the paged kernel over its own pool. Whether
  any slot has committed pages (the kernel's launch, JAX's empty-pool gate)
  is decided per rank from its own slots: the kernel has no collective
  inside, and its empty state gives the same merge.

Only the production path is taken, as in JAX: `kernel="chunked"` with
`window_appends`, both opt-ins off; speculative windows are refused.
"""

from __future__ import annotations

from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.inference.paged_engine import (PagedEngineConfig,
                                                      PagedInferenceEngine)
from flasht5_tpu_torch.inference.sharded_engine import DataSharded
from flasht5_tpu_torch.parallel.mesh import use_mesh


class ShardedPagedEngine(DataSharded, PagedInferenceEngine):
    """`PagedInferenceEngine` across the ranks of `mesh`
    (`sharded_engine.make_serving_mesh`): the same PagedEngineConfig
    (`num_pages` = pages a data rank), scheduler and Request API; every
    rank constructs it with the whole parameter tree on its own device and
    calls `run` with the same requests."""

    def __init__(self, config: FlashT5Config, params,
                 ecfg: PagedEngineConfig, mesh, device=None):
        if not (ecfg.kernel == "chunked" and ecfg.window_appends):
            raise ValueError("sharded paged serving takes the production "
                             "path only (kernel='chunked', "
                             "window_appends=True)")
        if ecfg.dense_read_max or ecfg.window_stage_max_bytes:
            raise ValueError("sharded paged serving reads the pages with "
                             "the kernel: dense_read_max and "
                             "window_stage_max_bytes stay 0")
        config, local = self._shard(config, params, ecfg, mesh)
        with use_mesh(mesh):
            super().__init__(config, local, ecfg, device=device)
