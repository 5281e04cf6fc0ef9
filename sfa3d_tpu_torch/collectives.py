"""The collectives that a forward and its losses run under data
parallelism (`parallel/mesh.py`): the active process groups and a
differentiable sum over their ranks.

Inside `data_parallel(mesh)` a forward and its loss see two groups, as XLA
turns the reductions of a sharded jit into psums over the axes a value is
split on:
- `batch_group()`, the ranks that hold parts of the batch's frames or rows
  (the world: 'data' and 'spatial'), over which
  `models/resnet.py::FlaxBatchNorm2d` all-reduces its per-channel sums;
- `loss_group()`, the ranks that hold different frames' targets ('data'
  alone: the targets are not split by rows), over which the losses
  all-reduce their normalizers before they divide (None when the mesh
  has one data index).
On a 1-D mesh both are the mesh's group. Outside the context (or at world
size 1) both are None and no collective runs. This module imports torch
alone, so the models and the losses can use it without importing the
launch machinery of `parallel/mesh.py`.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

_ACTIVE_GROUPS: contextvars.ContextVar = contextvars.ContextVar("sfa3d_data_parallel_groups",
                                                                default=(None, None))


def batch_group():
    """The group BatchNorm reduces its statistics over inside a
    `data_parallel` context, or None outside one."""
    return _ACTIVE_GROUPS.get()[0]


def loss_group():
    """The group the losses reduce their normalizers over inside a
    `data_parallel` context, or None (outside one, or one data index)."""
    return _ACTIVE_GROUPS.get()[1]


def data_parallel(mesh):
    """The context in which a forward and its losses run over the mesh's
    groups: BatchNorm takes global statistics and the losses global
    normalizers. A null context without a mesh or when the mesh is not
    synced (world size 1)."""
    if mesh is None or not mesh.synced:
        return contextlib.nullcontext()
    return _group_context(mesh.process_group, mesh.loss_group)


@contextlib.contextmanager
def _group_context(batch, loss):
    token = _ACTIVE_GROUPS.set((batch, loss))
    try:
        yield batch
    finally:
        _ACTIVE_GROUPS.reset(token)


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
    """x summed over the ranks of `group` (default: the active loss group),
    as a new tensor; differentiable when x requires grad. Without a group,
    x."""
    group = loss_group() if group is None else group
    if group is None:
        return x
    if x.requires_grad:
        return _AllReduceSum.apply(group, x)
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y
