"""The collectives of a data-parallel or tensor-parallel train step.

They stand where XLA's collectives stood in the JAX package's jitted step:
:func:`all_reduce_mean` averages the gradients and the loss over the data
group, and :func:`global_moments` gives train-mode BatchNorm the statistics
of the global batch through a differentiable all-reduce.  Under channel
tensor parallelism a layer whose out-channels are sharded over the model
group runs ``gather_channels(op(copy_to_model(x), W_r))`` (Megatron's *f*
and *g*): :func:`copy_to_model` is the identity whose backward sums the
input's gradient over the model group, :func:`gather_channels` the
all-gather of the ranks' channel slices whose backward keeps this rank's
slice.  They use ``all_reduce`` and ``all_gather``, which Gloo also
carries on CUDA tensors.  This module imports nothing else of the port, so
the layers can use it.

Numerics: an all-reduce sums in another order than one process summing the
whole batch, so data-parallel weights agree with a single-process run to
float noise; all ranks hold the same bits.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

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


# Collectives of the tensor-parallel layers, counted by kind (``calls``) and
# by the bytes this rank contributes (``bytes``); a caller resets them.
tp_counts: Dict[str, int] = {"copy_to_model": 0, "gather_channels": 0, "bytes": 0}


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward all-reduces (sums) the gradient over the
    model group, since each rank's sharded op only sees the part of the
    input's gradient that flows through its own channels."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        tp_counts["copy_to_model"] += 1
        tp_counts["bytes"] += grad.numel() * grad.element_size()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherChannels(torch.autograd.Function):
    """All-gather of the ranks' equal channel slices along the last axis, in
    rank order; backward keeps this rank's slice of the gradient with no
    reduction.  (``torch.distributed.nn.functional.all_gather`` sums the
    gradient over the ranks in its backward: downstream of the gather every
    rank computes the same full gradient, so that sum would scale every
    sharded gradient by the group's size.)"""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        tp_counts["gather_channels"] += 1
        tp_counts["bytes"] += x.numel() * x.element_size()
        dist.all_gather(parts, x, group=group)
        ctx.lo, ctx.hi = rank * x.shape[-1], (rank + 1) * x.shape[-1]
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad[..., ctx.lo : ctx.hi].contiguous(), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the input of a sharded op (Megatron's *f*): the identity,
    whose gradient is summed over ``group`` in the backward."""
    return _CopyToModel.apply(x, group)


def gather_channels(x: torch.Tensor, group) -> torch.Tensor:
    """The full ``(..., C)`` tensor from every rank's ``(..., C / size)``
    slice (Megatron's *g*), slices in rank order; the backward hands each
    rank its slice of the gradient."""
    return _GatherChannels.apply(x, group)
