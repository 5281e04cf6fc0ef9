"""The port's kernel entries as `torch.library` custom ops, on the CPU: each
of the seven passes `torch.library.opcheck` (schema, autograd registration,
fake implementation against the real one, AOT dispatch with dynamic shapes)
at small shapes, each public wrapper is its op (one node of an exported
graph, the loop entries not unrolled), CPU and fake calls count no launch,
and the argument checks live in the real implementations.

The CPU implementation of each op is its plain PyTorch version; the CUDA one
(the hand-written kernel) runs on the card only (`chip_smoke.py`)."""

import numpy as np
import pytest
import torch

from sfa3d_tpu_torch.ops import bev_counts, fusion_loops, track_associate

OPS = ("bev_raster_reduce", "bev_cell_counts", "argoverse_raster_reduce", "hard_nms_keep",
       "soft_nms_gaussian", "greedy_match", "track_associate")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _boxes(rng, b, k):
    xy = rng.uniform(0, 40, (b, k, 2))
    wh = rng.uniform(2, 12, (b, k, 2))
    return torch.from_numpy(np.concatenate([xy, wh], -1).astype(np.float32))


def _valid(rng, b, k):
    return torch.from_numpy(rng.uniform(size=(b, k)) < 0.8)


def _inputs(name, seed=0):
    """(public wrapper, positional args of its op) at small shapes, seeded
    with numpy."""
    rng = np.random.default_rng(seed)
    b, n, h, w = 2, 300, 16, 24
    row = torch.from_numpy(rng.integers(-1, h + 2, (b, n)).astype(np.int32))
    col = torch.from_numpy(rng.integers(-1, w + 2, (b, n)).astype(np.int32))
    if name == "bev_raster_reduce":
        key = torch.from_numpy(rng.integers(-1, 1 << 25, (b, n)).astype(np.int32))
        row, col = row.clamp(-1, h - 1), col.clamp(-1, w - 1)
        dropped = (row < 0) | (col < 0)  # the prelude drops a point in all three
        row, col, key = row.masked_fill(dropped, -1), col.masked_fill(dropped, -1), key.masked_fill(dropped, -1)
        return bev_counts.bev_raster_reduce, (row, col, key, h, w)
    if name == "bev_cell_counts":
        return bev_counts.bev_cell_counts, (row, col, h, w)
    if name == "argoverse_raster_reduce":
        z = torch.from_numpy(rng.normal(0.5, 1.0, (b, n)).astype(np.float32))
        r = torch.from_numpy(rng.uniform(-0.2, 1.0, (b, n)).astype(np.float32))
        return bev_counts.argoverse_raster_reduce, (row, col, z, r, h, w)
    if name == "hard_nms_keep":
        return fusion_loops.hard_nms_keep, (_boxes(rng, b, 12), _valid(rng, b, 12), 0.3)
    if name == "soft_nms_gaussian":
        scores = torch.from_numpy(rng.uniform(0, 1, (b, 12)).astype(np.float32))
        return fusion_loops.soft_nms_gaussian, (_boxes(rng, b, 12), scores, _valid(rng, b, 12), 0.5, 0.001)
    if name == "greedy_match":
        return fusion_loops.greedy_match, (_boxes(rng, b, 9), _valid(rng, b, 9), _boxes(rng, b, 7),
                                           _valid(rng, b, 7), 0.1)
    iou = torch.from_numpy(rng.uniform(-1, 1, (b, 8, 6)).astype(np.float32))
    order = torch.from_numpy(np.stack([rng.permutation(8) for _ in range(b)]).astype(np.int32))
    return track_associate.track_associate, (iou, order, 0.01)


def _op(name):
    return getattr(torch.ops.sfa3d_torch, name).default


@pytest.mark.parametrize("name", OPS)
def test_opcheck(name):
    """Schema, autograd registration, the fake implementation's shapes,
    dtypes and strides against the CPU implementation's, and AOT dispatch
    with dynamic shapes."""
    _, args = _inputs(name)
    torch.library.opcheck(_op(name), args)


@pytest.mark.parametrize("name", OPS)
def test_wrapper_is_its_op_and_counts_no_cpu_or_traced_launch(name):
    """The public wrapper equals its op on the CPU (the plain version, bit
    for bit), is one node of a graph that torch.export traces through it,
    and neither the CPU call nor the trace (fake tensors) counts a launch."""
    fn, args = _inputs(name, seed=1)
    before = fn.launches
    got = fn(*args)
    want = _op(name)(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    scalars = [a for a in args if not isinstance(a, torch.Tensor)]

    class Call(torch.nn.Module):
        def forward(self, *ts):
            return fn(*ts, *scalars)

    ep = torch.export.export(Call(), tuple(tensors), strict=False)
    targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert [t for t in targets if "getitem" not in str(t)] == [_op(name)]  # one node, and a tuple's getitems
    assert fn.launches == before


@pytest.mark.parametrize("name", OPS)
def test_real_implementation_checks_its_arguments(name):
    """The argument checks run inside the real implementation: the op
    called directly refuses a wrong dtype, and (through its fake
    implementation) a meta tensor."""
    _, args = _inputs(name)
    bad = list(args)
    first = args[0]
    bad[0] = first.to(torch.int64) if first.dtype != torch.int64 else first.to(torch.int32)
    with pytest.raises((TypeError, ValueError)):
        _op(name)(*bad)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="cuda or cpu"):
        _op(name)(*meta)
