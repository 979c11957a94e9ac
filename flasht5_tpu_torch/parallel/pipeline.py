"""GPipe over the ranks of a "pipe" group: microbatches forward through
every stage, then backward.

The counterpart of `flasht5_tpu/parallel/pipeline.py` (:30-97). There every
device runs the same program each tick, and the bubble ticks compute on
garbage that is masked off; differentiating the loop gives the backward.
Here a stage waits for its input instead, and the backward is written out:

- `pipeline_forward` runs `fn(i, x)` on each microbatch i in order, x the
  first stage's own input or the activation received from the stage
  before (a leaf that will take its gradient), and sends each output on
  to the next stage; the stage keeps every microbatch's graph;
- `pipeline_backward` takes the microbatches in the same order: the last
  stage backpropagates from its roots (the losses, or outputs with given
  gradients), every other stage from the output gradient the next stage
  sends back, and each stage sends its input's gradient upstream.

Every send is matched by a receive of the same shape in the same order on
the neighbouring stage (`dist.batch_isend_irecv`); a mismatch hangs
rather than fails, so a caller runs these under a time limit.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


class Stage:
    """This rank's place in the pipe group. Making one runs a collective
    over the group: NCCL leaves a point-to-point call undefined (it hangs)
    where it is a group's first and not every rank of it takes part."""

    def __init__(self, group):
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl"
                  else torch.device("cpu"))
        dist.all_reduce(torch.zeros(1, device=device), group=group)
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.first = self.index == 0
        self.last = self.index == self.size - 1
        self.prev = (None if self.first
                     else dist.get_global_rank(group, self.index - 1))
        self.next = (None if self.last
                     else dist.get_global_rank(group, self.index + 1))
        self.last_rank = dist.get_global_rank(group, self.size - 1)

    def send(self, t: torch.Tensor, peer: int) -> None:
        for r in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, t.contiguous(), peer,
                            group=self.group)]):
            r.wait()

    def recv(self, like: torch.Tensor, peer: int) -> torch.Tensor:
        buf = torch.empty_like(like)
        for r in dist.batch_isend_irecv(
                [dist.P2POp(dist.irecv, buf, peer, group=self.group)]):
            r.wait()
        return buf


def pipeline_forward(stage: Stage, fn: Callable, n_microbatches: int,
                     inputs: Optional[Sequence[torch.Tensor]],
                     like: torch.Tensor):
    """(outputs on the last stage else None, the records for
    `pipeline_backward`). `inputs` are the first stage's microbatches;
    `like` has the shape and dtype of an activation between stages."""
    records, outputs = [], []
    for i in range(n_microbatches):
        if stage.first:
            x = inputs[i]
        else:
            x = stage.recv(like, stage.prev).requires_grad_(True)
        y = fn(i, x)
        if not stage.last:
            stage.send(y.detach(), stage.next)
        records.append((x, y))
        outputs.append(y)
    return (outputs if stage.last else None), records


def pipeline_backward(stage: Stage, records,
                      roots: Optional[List[torch.Tensor]] = None,
                      grads: Optional[List[torch.Tensor]] = None) -> None:
    """The backward of `pipeline_forward`'s microbatches. On the last stage
    `roots[i]` (with `grads[i]`, or None for a scalar) stands for
    microbatch i's output; the other stages take the gradient of their
    output from the next stage."""
    for i, (x, y) in enumerate(records):
        if stage.last:
            torch.autograd.backward(roots[i],
                                    None if grads is None else grads[i])
        else:
            torch.autograd.backward(y, stage.recv(y, stage.next))
        if not stage.first:
            stage.send(x.grad, stage.prev)
