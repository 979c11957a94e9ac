"""Seeded T5 v1.1 weights, made on the device in one draw.

The tree has the port's layout and key names (the input format of its
`Trainer` and engines) and T5's initialization scales. Every normal leaf is
a slice of one `torch.randn` on the card, so the same seed gives the same
weights to the program and, made again after the window, to the reference.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Leaf = Tuple[Tuple, Tuple[int, ...], float]


def _leaves(m: Dict) -> Tuple[List[Leaf], List[Tuple]]:
    """(normal leaves as (path, shape, std), ones leaves' paths), in a fixed
    order, for the model_args `m` (T5 v1.1, untied lm_head, T5 bias)."""
    d, dkv, h, dff = m["d_model"], m["d_kv"], m["num_heads"], m["d_ff"]
    inner, f = h * dkv, float(m.get("initializer_factor", 1.0))
    normal, ones = [], []

    def attention(prefix, has_pe):
        normal.append((prefix + ("Wq",), (d, inner), f * (d * dkv) ** -0.5))
        normal.append((prefix + ("Wk",), (d, inner), f * d ** -0.5))
        normal.append((prefix + ("Wv",), (d, inner), f * d ** -0.5))
        normal.append((prefix + ("o",), (inner, d), f * inner ** -0.5))
        if has_pe:
            normal.append((prefix + ("pe_encoding", "relative_attention_bias"),
                           (m.get("relative_attention_num_buckets", 32), h),
                           f * d ** -0.5))

    for stack in ("encoder", "decoder"):
        n = m["num_layers"] if stack == "encoder" else m.get(
            "num_decoder_layers") or m["num_layers"]
        for i in range(n):
            b = (stack, "block", i)
            attention(b + ("self_attention_layer", "self_attention"), i == 0)
            ones.append(b + ("self_attention_layer", "layer_norm", "weight"))
            if stack == "decoder":
                attention(b + ("cross_attention_layer", "cross_attention"),
                          False)
                ones.append(b + ("cross_attention_layer", "layer_norm",
                                 "weight"))
            normal.append((b + ("ff_layer", "act", "wi_0"), (d, dff),
                           f * d ** -0.5))
            normal.append((b + ("ff_layer", "act", "wi_1"), (d, dff),
                           f * d ** -0.5))
            normal.append((b + ("ff_layer", "wo"), (dff, d), f * dff ** -0.5))
            ones.append(b + ("ff_layer", "layer_norm", "weight"))
        ones.append((stack, "final_layer_norm", "weight"))
    normal.append((("shared", "embedding"), (m["vocab_size"], d), f))
    normal.append((("lm_head",), (d, m["vocab_size"]), f * d ** -0.5))
    return normal, ones


def _put(tree: Dict, path: Tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
        elif key not in node:
            node[key] = [] if isinstance(nxt, int) else {}
        node = node[key]
    node[path[-1]] = value


def make(model_args: Dict, seed: int, device) -> Dict:
    """The float32 parameter tree (the configurations' `param_dtype`):
    every normal leaf scaled from one draw of `torch.randn` from `seed` on
    `device`, the norms' weights all ones."""
    normal, ones = _leaves(model_args)
    total = sum(_numel(shape) for _, shape, _ in normal)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn((total,), generator=gen, device=device,
                       dtype=torch.float32)
    tree: Dict = {}
    start = 0
    for path, shape, std in normal:
        n = _numel(shape)
        _put(tree, path, flat[start:start + n].view(shape) * std)
        start += n
    del flat
    d = model_args["d_model"]
    for path in ones:
        _put(tree, path, torch.full((d,), float(model_args.get(
            "initializer_factor", 1.0)), device=device))
    return tree


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def leaves(tree, prefix=()) -> List[Tuple[Tuple, torch.Tensor]]:
    """[(path, leaf)] in the port's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves(v, prefix + (i,))]
    return [(prefix, tree)]
