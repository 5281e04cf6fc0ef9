"""The collectives that a forward and its losses run under data
parallelism (`parallel/mesh.py`): the active process group and a
differentiable sum over its ranks.

Inside `data_parallel(mesh)` a forward and its loss see the group through
`active_group()`: `models/resnet.py::FlaxBatchNorm2d` all-reduces its
per-channel sums, and the losses all-reduce their normalizers before they
divide, as XLA turns the reductions of a data-sharded jit into psums.
Outside one (or at world size 1) `active_group()` is None and no
collective runs. This module imports torch alone, so the models and the
losses can use it without importing the launch machinery of
`parallel/mesh.py`.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

_ACTIVE_GROUP: contextvars.ContextVar = contextvars.ContextVar("sfa3d_data_parallel_group", default=None)


def active_group():
    """The process group of the enclosing `data_parallel` context, or None
    outside one (or at world size 1)."""
    return _ACTIVE_GROUP.get()


def data_parallel(mesh):
    """The context in which a forward and its losses run over the mesh's
    group: BatchNorm takes global statistics and the losses global
    normalizers. A null context without a mesh or when the mesh is not
    synced (world size 1)."""
    if mesh is None or not mesh.synced:
        return contextlib.nullcontext()
    return _group_context(mesh.process_group)


@contextlib.contextmanager
def _group_context(group):
    token = _ACTIVE_GROUP.set(group)
    try:
        yield group
    finally:
        _ACTIVE_GROUP.reset(token)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the incoming gradients over the
    ranks (every rank's loss reads the same global value), as XLA's
    transpose of a psum."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return None, g


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """x summed over the ranks of `group` (default: the active one), as a
    new tensor; differentiable when x requires grad. Without a group, x."""
    group = active_group() if group is None else group
    if group is None:
        return x
    if x.requires_grad:
        return _AllReduceSum.apply(group, x)
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y
