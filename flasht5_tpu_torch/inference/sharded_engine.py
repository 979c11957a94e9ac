"""Serving across ranks: the slot engine on a ("data", "tensor") mesh.

The PyTorch counterpart of `flasht5_tpu/inference/sharded_engine.py`. One
process a card (one rank), every rank running the same host scheduler
(`InferenceEngine.run`) on its share of the device work:

- weights: the Megatron layout of `parallel/sharding.py` (heads and d_ff by
  column, the o-projections and wo by row, the lm_head over the vocabulary,
  the bias table over heads), quantized leaves included;
- slot pool: each data rank holds `max_slots / data` slots (slot s on data
  rank s // (max_slots / data)) and each tensor rank H / t heads of them;
- decode: no collective over "data"; over "tensor" the row-split products
  of a block (self o, cross o, wo: an all-reduce, or the ring under
  `use_collective_matmul`) and the vocab-parallel next token;
- prefill: the batch's rows split over "data" (at least one a data rank),
  then an all-gather of each layer's cross K/V over "data", so that the
  rank that owns a slot can write any request into it;
- insert: the owner's in-place write (JAX's masked SPMD write keyed on the
  global slot id; in processes the owner alone writes);
- window: its (3, k, B_local) outputs all-gathered over "data", so every
  rank's scheduler sees the single-device interface and takes the same
  decisions.

Where the JAX engines run under one controller, each rank here runs its own
scheduler, so the decisions that read a clock are taken once: rank 0 says
how many waiting requests have arrived (`_visible`, a broadcast over a gloo
group of every rank, which does not wait on the card), and the others
follow. Every data rank runs every window, whether or not its slots are
live, since the window's collectives need every rank.

JAX's refusals are mirrored at construction (`max_slots % data == 0`, data
a power of two), and speculative windows (`spec_window >= 2`) are refused
there too (JAX fails mid-run).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.distributed as dist

from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.inference.engine import (EngineConfig, InferenceEngine,
                                                Request, encode_cross)
from flasht5_tpu_torch.parallel.mesh import make_mesh, use_mesh
from flasht5_tpu_torch.parallel.sharding import shard_params


def make_serving_mesh(data: int = 1, tensor: int = 1):
    """The ("data", "tensor") serving mesh over every rank of the default
    process group, tensor innermost (tensor partners are neighbouring
    ranks, the cards of one host)."""
    return make_mesh(data, tensor)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's x of `group`, joined along dim in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class DataSharded:
    """The collectives of a sharded engine, for a base engine whose device
    work is shard-oblivious (`InferenceEngine`, `PagedInferenceEngine`):
    the prefill's rows over "data", window outputs and probe logits
    gathered, the arrivals decided by rank 0. Public calls run inside the
    mesh (`use_mesh`), where the model finds its tensor group."""

    def _shard(self, config: FlashT5Config, params, ecfg, mesh):
        """Check the mesh and the slot split; return the tensor-parallel
        config and this rank's parameter shards."""
        names = mesh.mesh_dim_names or ()
        if not {"data", "tensor"} <= set(names):
            raise ValueError(f"a serving mesh has 'data' and 'tensor' "
                             f"dimensions, not {names}")
        data = mesh.size(names.index("data"))
        if ecfg.max_slots % data:
            raise ValueError(f"max_slots {ecfg.max_slots} does not split "
                             f"over {data} data ranks")
        if data & (data - 1):
            raise ValueError(f"data={data} must be a power of two")
        if getattr(ecfg, "spec_window", 0) >= 2:
            raise ValueError("speculative windows (spec_window >= 2) run on "
                             "the single-device slot engine only")
        self.mesh = mesh
        self._data = data
        self._data_rank = mesh.get_local_rank("data")
        self._data_group = mesh.get_group("data")
        # the scheduler's decisions travel on the host
        self._host_group = dist.new_group(backend="gloo")
        return config.replace(tp_axis="tensor"), shard_params(params, mesh)

    def _prefill_batch(self, n: int) -> int:
        # rows split over "data": at least one a data rank
        return max(super()._prefill_batch(n), self._data)

    def _encode(self, ids: np.ndarray):
        per = ids.shape[0] // self._data
        mine = ids[self._data_rank * per:(self._data_rank + 1) * per]
        return [tuple(_gather(x, self._data_group, 0) for x in kv)
                for kv in encode_cross(self.config, self.params, mine,
                                       self.device)]

    def _gather_slots(self, x: torch.Tensor) -> torch.Tensor:
        return _gather(x, self._data_group, 0 if x.dim() < 3 else -1)

    def _gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        if self.config.tie_word_embeddings:
            return logits
        return _gather(logits, self._group, -1)

    def _visible(self, waiting: List[Request], t: float) -> int:
        n = torch.tensor([super()._visible(waiting, t)], dtype=torch.int64)
        dist.broadcast(n, src=dist.get_global_rank(self._host_group, 0),
                       group=self._host_group)
        return int(n)

    def run(self, requests, *args, **kw):
        with use_mesh(self.mesh):
            return super().run(requests, *args, **kw)

    def warmup(self, *args, **kw):
        with use_mesh(self.mesh):
            return super().warmup(*args, **kw)


class ShardedEngine(DataSharded, InferenceEngine):
    """`InferenceEngine` across the ranks of `mesh` (`make_serving_mesh`):
    the same EngineConfig, scheduler and Request API. Every rank of the
    mesh constructs it with the whole parameter tree on its own device
    (`device`, default `cuda`) and calls `run` with the same requests;
    each keeps its shards. With mesh (1, 1) it is the single-device engine
    plus collectives over one rank."""

    def __init__(self, config: FlashT5Config, params, ecfg: EngineConfig,
                 mesh, device=None):
        config, local = self._shard(config, params, ecfg, mesh)
        with use_mesh(mesh):
            super().__init__(config, local, ecfg, device=device)

    def probe_step(self, token_override=None):
        """One step returning every slot's next token and the full (B, V)
        logits (gathered over "tensor", then "data")."""
        with use_mesh(self.mesh):
            return super().probe_step(token_override)

    def admit_request(self, req: Request, slot: int) -> None:
        with use_mesh(self.mesh):
            super().admit_request(req, slot)
