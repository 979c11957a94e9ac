"""Megatron-style tensor-parallel layout of the T5 parameters.

The counterpart of `flasht5_tpu/parallel/sharding.py`, with its rules
(:26-61). A leaf's spec is the dimension the mesh's "tensor" dimension
splits, or None where every tensor rank holds it whole:

- attention Wq/Wk/Wv: by column, over heads   (d_model, H*d_kv/t)  1
- attention o:        by row                  (H*d_kv/t, d_model)  0
- MLP wi/wi_0/wi_1:   by column               (d_model, d_ff/t)    1
- MLP wo:             by row                  (d_ff/t, d_model)    0
- lm_head:            by column, over vocab   (d_model, V/t)       1
- relative bias:      by column, over heads   (num_buckets, H/t)   1
- embeddings, norms, FIRE's MLP, scalars: whole                    None

A QuantizedTensor's `qvalues` split as the weight does and its `scales`
follow the output dimension: a column-split weight splits them with its
columns; a row-split weight keeps per-channel (1, out) scales whole and
splits group scales (in/g, out) by row.

`param_shardings` (a `NamedSharding` tree) has no counterpart: a rank holds
its shard itself (`shard_params`), and `gather_params` rebuilds the whole
tree.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from flasht5_tpu_torch.ops.quant import QuantizedTensor
from flasht5_tpu_torch.quantize import _map_with_path

ROW, COL = 0, 1


def _base_spec(path: str) -> Optional[int]:
    if any(k in path for k in ("'Wq'", "'Wk'", "'Wv'")):
        return COL
    if path.endswith("['o']"):
        return ROW
    if any(k in path for k in ("'wi'", "'wi_0'", "'wi_1'")):
        return COL
    if "'wo'" in path:
        return ROW
    if "lm_head" in path:
        return COL
    if "relative_attention_bias" in path:
        return COL
    return None


def spec_for(path: str, leaf) -> Any:
    """The split dimension of one leaf (`path` as `jax.tree_util.keystr`
    writes it); a QuantizedTensor gets a QuantizedTensor of two specs."""
    if isinstance(leaf, QuantizedTensor):
        spec = _base_spec(path)
        scales = spec
        if spec == ROW and leaf.scales.shape[0] == 1:
            scales = None
        return QuantizedTensor(spec, scales)
    return _base_spec(path)


def param_pspecs(params) -> Any:
    """The spec tree of a parameter tree (nested dicts and lists)."""
    return _map_with_path(spec_for, params)


def tree_map(fn, tree):
    """fn over the tensors of a tree of dicts, lists and QuantizedTensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(fn(tree.qvalues), fn(tree.scales))
    return None if tree is None else fn(tree)


def tree_map2(fn, tree, specs):
    """fn(leaf, spec) over a tree and its spec tree (a QuantizedTensor's
    two parts each with its own spec)."""
    if isinstance(tree, dict):
        return {k: tree_map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map2(fn, v, s) for v, s in zip(tree, specs)]
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(fn(tree.qvalues, specs.qvalues),
                               fn(tree.scales, specs.scales))
    return fn(tree, specs)


def shard_leaf(x: torch.Tensor, dim: Optional[int], index: int,
               count: int) -> torch.Tensor:
    """Shard `index` of `count` equal pieces of x along dim (a copy)."""
    if dim is None or x is None:
        return x
    if x.shape[dim] % count:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split into {count}")
    per = x.shape[dim] // count
    return x.narrow(dim, index * per, per).contiguous().clone()


def gather_leaf(x: torch.Tensor, dim: Optional[int], group) -> torch.Tensor:
    """Every rank's shard of x along dim, joined in rank order."""
    if dim is None or x is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def shard_tree(tree, specs, mesh, dim_name: str = "tensor"):
    """This rank's shards of a whole tree over mesh dimension `dim_name`."""
    names = mesh.mesh_dim_names
    count = mesh.size(names.index(dim_name))
    index = mesh.get_local_rank(dim_name)
    return tree_map2(lambda x, s: shard_leaf(x, s, index, count), tree,
                     specs)


def gather_tree(tree, specs, mesh, dim_name: str = "tensor"):
    """The whole tree from every rank's shards over `dim_name`, on every
    rank of that dimension (a collective: each of them calls it)."""
    group = mesh.get_group(dim_name)
    return tree_map2(lambda x, s: gather_leaf(x, s, group), tree, specs)


def shard_params(params, mesh):
    """This rank's tensor-parallel shard of a whole parameter tree."""
    return shard_tree(params, param_pspecs(params), mesh)


def gather_params(local, mesh, dst: Optional[int] = None):
    """The whole tree from the ranks' shards, on every rank, or (`dst`, a
    global rank) only there: the others get None. Specs are read from the
    local tree, whose paths are the whole tree's."""
    full = gather_tree(local, param_pspecs(local), mesh)
    if dst is not None and dist.get_rank() != dst:
        return None
    return full


def batch_slice(mesh, global_batch_size: int) -> slice:
    """This rank's rows of a global batch: its share over "data" (every
    tensor rank of a data index loads the same rows)."""
    names = mesh.mesh_dim_names
    count = mesh.size(names.index("data"))
    if global_batch_size % count:
        raise ValueError(f"batch {global_batch_size} does not split over "
                         f"{count} data ranks")
    per = global_batch_size // count
    index = mesh.get_local_rank("data")
    return slice(index * per, (index + 1) * per)
