"""AdamWScale: AdamW with Adafactor-style RMS(param) LR scaling, optional
Kahan-compensated updates for low-precision params, and optional
low-precision optimizer state.

The counterpart of `flasht5_tpu/optim/adamw_scaled.py::adamw_scale`, with
the same arithmetic (its :114-156), as a `torch.optim.Optimizer` that updates
the parameters in place:
- m and v updated in fp32, then stored in `state_dtype` (default the
  parameter's dtype);
- the bias correction folded into the step size, lr * sqrt(1 - b2^t) /
  (1 - b1^t);
- the step size scaled per parameter by max(1e-3, rms(p));
- for bf16/f16 parameters with `kahan_sum`, the Kahan-compensated update;
- decoupled weight decay applied after the update as p * (1 - lr * wd),
  with `weight_decay` set per parameter group (`no_decay_mask` splits the
  leaves into the decayed and the undecayed group by name).

The arithmetic runs as `torch._foreach_*` operations over each group's
list, a few multi-tensor launches each, and bf16/f16 parameters take a
per-leaf loop. The per-leaf scale stays on the device (no host sync), as a
multiply by a list of 0-d tensors, which PyTorch runs one launch per leaf:
a FAT5-small step costs ~370 launches in all (PERF.md).

The sharded statistics are options of a parameter group (JAX :58-68,
:101-112), as torch optimizers take per-group options:
- `stat_axes`: a process group (or None) over which a split leaf's sum of
  squares and element count are summed before the rms, so that the scale
  is the unsplit leaf's (the tensor group for the tensor-split leaves);
- `stat_batch_dims`: the number of leading axes along which a leaf is
  taken as separate parameters, each with its own rms (1 for the
  pipeline's stacked layers).
The constructor's values are the defaults of groups that name none.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Union

import torch
import torch.distributed as dist

_NO_DECAY_SUBSTRINGS = ("bias", "layer_norm", "layernorm", "LayerNorm", "ln")
_LOW_PRECISION = (torch.bfloat16, torch.float16)


def no_decay_mask(paths: Iterable[str]) -> List[bool]:
    """True for decayed leaves, False for norm/bias leaves: the JAX
    package's rule on the same path names (`models.t5.tree_leaves_with_path`
    writes them as `jax.tree_util.keystr` does)."""
    return [not any(s in path for s in _NO_DECAY_SUBSTRINGS)
            for path in paths]


class AdamWScale(torch.optim.Optimizer):
    """`lr` is a float or a schedule, a function of the step count (1 on
    the first step) returning a float."""

    def __init__(self, params, lr: Union[float, Callable[[int], float]] = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0, kahan_sum: bool = False,
                 state_dtype: Optional[torch.dtype] = None,
                 stat_axes=None, stat_batch_dims: int = 0):
        super().__init__(params, dict(weight_decay=weight_decay,
                                      stat_axes=stat_axes,
                                      stat_batch_dims=stat_batch_dims))
        for group in self.param_groups:
            axes = group["stat_axes"]
            if axes is not None and not isinstance(axes, dist.ProcessGroup):
                raise TypeError(f"stat_axes {axes!r}: a process group (the "
                                f"mesh dimension's, `mesh.get_group`) or "
                                f"None")
            bd = group["stat_batch_dims"]
            if not isinstance(bd, int) or bd < 0 or any(
                    p.dim() < bd for p in group["params"]):
                raise ValueError(f"stat_batch_dims {bd!r}: an int from 0 "
                                 f"to each leaf's number of dimensions")
        self.lr = lr
        self.betas = betas
        self.eps = eps
        self.kahan_sum = kahan_sum
        self.state_dtype = state_dtype
        self.step_count = 0
        self._sqrt_numel = {}

    def state_dict(self) -> dict:
        """The step count and each parameter's state (m, v and, where kept,
        the Kahan compensation), parameters in the groups' order."""
        return {"step_count": self.step_count,
                "state": [dict(self.state[p]) for group in self.param_groups
                          for p in group["params"]]}

    def load_state_dict(self, state_dict: dict) -> None:
        """Restores `state_dict()` in place, in the dtypes this optimizer
        keeps (torch's own loader would cast the state to each parameter's
        dtype, which `state_dtype` may differ from)."""
        params = [p for group in self.param_groups for p in group["params"]]
        if len(params) != len(state_dict["state"]):
            raise ValueError(f"optimizer state for {len(state_dict['state'])}"
                             f" parameters, this optimizer has {len(params)}")
        for p, saved in zip(params, state_dict["state"]):
            if saved:
                state = self._state(p)
                for key, value in saved.items():
                    state[key].copy_(value)
        self.step_count = int(state_dict["step_count"])

    def lr_at(self, step: int) -> float:
        return self.lr(step) if callable(self.lr) else self.lr

    def _state(self, p: torch.Tensor) -> dict:
        st = self.state[p]
        if not st:
            dt = self.state_dtype or p.dtype
            st["exp_avg"] = torch.zeros_like(p, dtype=dt)
            st["exp_avg_sq"] = torch.zeros_like(p, dtype=dt)
            if self.kahan_sum and p.dtype in _LOW_PRECISION:
                st["kahan_comp"] = torch.zeros_like(p)
        return st

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.step_count += 1
        t = self.step_count
        b1, b2 = self.betas
        lr = self.lr_at(t)
        step_size = lr * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        for gi, group in enumerate(self.param_groups):
            params = group["params"]
            if not params:
                continue
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            states = [self._state(p) for p in params]
            self._update(gi, group, grads, states, b1, b2, step_size,
                         1.0 - lr * group["weight_decay"])
        return loss

    def _update(self, gi, group, grads, states, b1, b2, step_size, decay):
        params = group["params"]
        g32 = [g.float() for g in grads]
        m_st = [s["exp_avg"] for s in states]
        v_st = [s["exp_avg_sq"] for s in states]
        # .float() is the state itself when it is fp32 (updated in place)
        m32 = [m.float() for m in m_st]
        v32 = [v.float() for v in v_st]
        torch._foreach_mul_(m32, b1)
        torch._foreach_add_(m32, g32, alpha=1.0 - b1)
        torch._foreach_mul_(v32, b2)
        torch._foreach_addcmul_(v32, g32, g32, value=1.0 - b2)
        denom = torch._foreach_sqrt(v32)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(m32, denom)

        # step size per leaf: step_size * max(1e-3, rms(p))
        axes, bd = group["stat_axes"], group["stat_batch_dims"]
        count = 1 if axes is None else dist.get_world_size(axes)
        if bd:
            for p, u in zip(params, upd):
                u.mul_(self._batched_scale(p, bd, axes, count) * step_size)
        else:
            if gi not in self._sqrt_numel:
                self._sqrt_numel[gi] = torch.tensor(
                    [math.sqrt(p.numel() * count) for p in params],
                    dtype=torch.float32, device=params[0].device)
            norms = torch.stack(torch._foreach_norm(
                [p.float() for p in params]))
            if axes is not None:
                sq = norms * norms
                dist.all_reduce(sq, group=axes)
                norms = torch.sqrt(sq)
            scale = torch.clamp(norms / self._sqrt_numel[gi],
                                min=1e-3) * step_size
            torch._foreach_mul_(upd, list(scale.unbind(0)))

        full = [i for i, p in enumerate(params) if p.dtype == torch.float32]
        if full:
            ps = [params[i] for i in full]
            torch._foreach_sub_(ps, [upd[i] for i in full])
            if decay != 1.0:
                torch._foreach_mul_(ps, decay)
        for i, p in enumerate(params):
            if p.dtype != torch.float32:
                self._low_precision_update(p, -upd[i],
                                           states[i].get("kahan_comp"), decay)
        low = [i for i, m in enumerate(m_st) if m.dtype != torch.float32]
        if low:
            for st, new in ((m_st, m32), (v_st, v32)):
                torch._foreach_copy_([st[i] for i in low],
                                     [new[i] for i in low])

    @staticmethod
    def _batched_scale(p, bd, axes, count):
        """max(1e-3, rms) over all but the first `bd` axes of p, shaped to
        broadcast against p."""
        dims = tuple(range(bd, p.dim()))
        sq = torch.sum(p.float() ** 2, dim=dims, keepdim=True)
        if axes is not None:
            dist.all_reduce(sq, group=axes)
        n = count
        for d in dims:
            n *= p.shape[d]
        return torch.clamp(torch.sqrt(sq / n), min=1e-3)

    @staticmethod
    def _low_precision_update(p, upd, kc, decay):
        p32 = p.float()
        if kc is not None:
            kc32 = kc.float() + upd
            p_new = (p32 + kc32).to(p.dtype)
            kc.copy_(kc32 - (p_new.float() - p32))
        else:
            p_new = (p32 + upd).to(p.dtype)
        if decay != 1.0:
            p_new = (p_new.float() * decay).to(p.dtype)
        # the JAX package returns the update rounded to p's dtype and adds
        # it (optax.apply_updates), which for bf16 may differ from p_new
        p.add_((p_new.float() - p32).to(p.dtype))
