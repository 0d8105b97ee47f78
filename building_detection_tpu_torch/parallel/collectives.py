"""The collectives of a data-parallel train step.

They stand where XLA's collectives stood in the JAX package's jitted step:
:func:`all_reduce_mean` averages the gradients and the loss over the data
group, and :func:`global_moments` gives train-mode BatchNorm the statistics
of the global batch through a differentiable all-reduce.  They use only
``all_reduce``, which Gloo also carries on CUDA tensors.  This module
imports nothing else of the port, so the layers can use it.

Numerics: an all-reduce sums in another order than one process summing the
whole batch, so data-parallel weights agree with a single-process run to
float noise; all ranks hold the same bits.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

def all_reduce_mean(tensors: Sequence[torch.Tensor], group) -> list:
    """The mean over the ranks of ``group`` of each tensor (one dtype):
    flattened into one buffer, one all-reduce (sum), divided by the group's
    size, and split back into views of the buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()
    return out


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the gradient: each rank's
    input then receives the gradient of every rank's loss, as one process
    differentiating the whole batch would give it."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def global_moments(x: torch.Tensor, axes: Tuple[int, ...], group) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``(mean, biased variance, count)`` over ``axes`` of the global batch
    whose equal parts the ranks of ``group`` hold, two-pass as ``jnp.var``:
    the summed sums over the global count, then the summed squared
    deviations from that mean over it.  Differentiable; f32 in, f32 out."""
    n = (x.numel() // x.shape[-1]) * dist.get_world_size(group)
    mean = _SumOverRanks.apply(x.sum(dim=axes), group) / n
    var = _SumOverRanks.apply(torch.square(x - mean).sum(dim=axes), group) / n
    return mean, var, n
