"""The numbers that decide `correct`.

Training: the gap between the program's and the reference's norm of each
leaf (not the norm of their difference), over the reference's norm of that
leaf or of the median leaf, whichever is larger, taken at the worst leaf.
Leaves whose reference gradient is under a thousandth of the median leaf's
(nought to rounding) are left out by that rule, not by name.

Serving: for each served token, how far its logit lies below the
reference's best at that position; the widest such gap.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Set

import torch


def moving_leaves(ref_grad_norms: Dict[str, float]) -> Set[str]:
    med = statistics.median(ref_grad_norms.values())
    return {k for k, v in ref_grad_norms.items() if v >= 1e-3 * med}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   keep: Optional[Iterable[str]] = None):
    """(gap, leaf) at the worst leaf of those in `keep` (default all)."""
    names = sorted(keep if keep is not None else ref)
    med = statistics.median(ref[k] for k in names)
    worst, at = -1.0, None
    for k in names:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med)
        if gap > worst:
            worst, at = gap, k
    return worst, at


def relative_gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def served_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """max over positions of (the reference's best logit - its logit of the
    served token); ref_logits (L, V) float32, tokens (L,)."""
    best = ref_logits.max(dim=-1).values
    picked = ref_logits.gather(1, tokens.long()[:, None])[:, 0]
    return float((best - picked).max())
