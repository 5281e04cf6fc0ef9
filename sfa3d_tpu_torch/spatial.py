"""Row sharding: the 'spatial' axis of a (data x spatial) mesh
(`parallel/mesh.py::make_mesh_2d`), the counterpart of the JAX package's
BEV rows sharded over 'spatial', where XLA's SPMD partitioner writes the
halo exchanges. PyTorch has no partitioner, so this module writes them.

A feature map (B, C, H, W) is split by rows over the n ranks of a spatial
group. One rule, used everywhere, gives the global rows [lo, hi) that
spatial index s owns: `row_range(H, n, s)`, ceil(H / n) rows a rank in
order, as XLA splits an axis, so the last ranks may own fewer rows or none
(layer4 of a 64 x 64 raster has 2 rows for 4 ranks).

- `fetch_rows(x, height, requests, pad)` gives each rank the global rows
  [a, b) it asks for (`requests[s]` is spatial index s's (a, b): every rank
  knows every rank's request, since they come from one geometry), from any
  owner; rows outside [0, height) are `pad` (0, or -inf for a max-pool).
  Its backward is the transpose: each fetched row's gradient goes back to
  its owner and is added there.
- `gather_rows(x)` gives every rank of the group the whole map. Its
  backward keeps the rank's own rows of the incoming gradient: every rank
  of the group holds a copy of the same loss, so a sum would count it n
  times.
- Inside `row_sharded(mesh, height, width)` the layers of the models
  compute only the output rows their rank owns: `RowConv2d` fetches
  exactly the input rows those rows read, [lo * s - p, (hi - 1) * s - p +
  k), and convolves them with no row padding; `RowMaxPool2d` fetches with
  a -inf halo; `RowConvTranspose2d` fetches the input rows its output rows
  read and crops; `models/kfpn.py` and `models/yolov8.py` route their
  upsamples through `rows_of_product` and `upsample_nearest_rows`. A rank
  that owns no output rows returns an empty tensor without calling the op
  (cuDNN and MKL-DNN refuse some empty shapes), whose backward gives zero
  gradients, so every rank still runs every exchange of the backward.
  Outside the context the layers are their torch base classes.

The context maps a feature map's width to its global height: the input's,
then each sharded layer's output. A width met with two heights raises, and
so does a map whose local rows are not what the rule gives its rank.

Transport, by the group's backend (`_transport`): NCCL takes
`dist.batch_isend_irecv`; gloo takes `isend` / `irecv` of CPU tensors, and
CUDA tensors are staged through host memory (gloo has no point-to-point
for CUDA tensors). No route is reached by catching an error, and a failed
exchange raises. `EXCHANGES` counts the exchanges that moved rows, their
messages and bytes, and the seconds spent staging rows through the host.

This module imports torch alone, so the models can import it.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

Rows = Tuple[int, int]

EXCHANGES = {"exchanges": 0, "messages": 0, "bytes": 0, "staging_s": 0.0}


def reset_exchange_counts() -> None:
    """Set every count of EXCHANGES to zero."""
    EXCHANGES.update(exchanges=0, messages=0, bytes=0, staging_s=0.0)


def row_range(height: int, parts: int, index: int) -> Rows:
    """The global rows [lo, hi) of a `height`-row map that spatial index
    `index` of `parts` owns: ceil(height / parts) rows a rank, in order;
    hi == lo for a rank past the last row."""
    per = -(-height // parts)
    lo = min(index * per, height)
    return lo, min(lo + per, height)


class RowSharding:
    """One rank's view of the row split of one network's input: the
    spatial `group`, the global ranks of its members in spatial order
    (`ranks`), this rank's spatial `index`, and the global height of each
    feature-map width met so far."""

    def __init__(self, group, ranks: Sequence[int], index: int, height: int, width: int):
        self.group, self.ranks, self.index = group, tuple(ranks), index
        self.heights: Dict[int, int] = {}
        self.register(width, height)

    @property
    def size(self) -> int:
        return len(self.ranks)

    def rows(self, height: int, index: Optional[int] = None) -> Rows:
        return row_range(height, self.size, self.index if index is None else index)

    def register(self, width: int, height: int) -> None:
        """Record that maps of this width are `height` rows high."""
        if self.heights.setdefault(width, height) != height:
            raise ValueError(f"maps of width {width} are {self.heights[width]} rows high, not {height}: "
                             "the row split needs one height per width")

    def height(self, x: torch.Tensor) -> int:
        """The global height of a row-sharded map x (its local rows
        checked against the rule)."""
        width = x.shape[-1]
        if width not in self.heights:
            raise ValueError(f"no global height is known for maps of width {width}")
        height = self.heights[width]
        lo, hi = self.rows(height)
        if x.shape[-2] != hi - lo:
            raise ValueError(f"a map of width {width} holds {x.shape[-2]} rows on spatial index {self.index}; "
                             f"rows [{lo}, {hi}) of {height} are its")
        return height


_ACTIVE_ROWS: contextvars.ContextVar = contextvars.ContextVar("sfa3d_row_sharding", default=None)


def active_rows() -> Optional[RowSharding]:
    """The row sharding of the enclosing `row_sharded` context, or None."""
    return _ACTIVE_ROWS.get()


def row_sharded(mesh, height: int, width: int):
    """The context in which a network whose input is `height` x `width`
    runs on this rank's rows of it (`parallel/mesh.py::shard_rows`); yields
    the RowSharding. A null context (yielding None) without a mesh or with
    one spatial rank."""
    if mesh is None or mesh.spatial_size == 1:
        return contextlib.nullcontext()
    return _rows_context(RowSharding(mesh.spatial_group, mesh.spatial_ranks, mesh.spatial_index, height, width))


@contextlib.contextmanager
def _rows_context(sharding: RowSharding):
    token = _ACTIVE_ROWS.set(sharding)
    try:
        yield sharding
    finally:
        _ACTIVE_ROWS.reset(token)


def shard_rows(mesh, x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """This rank's rows of x along `axis` (-2: the H of NCHW; 1 for NHWC
    images) over the mesh's 'spatial' axis, by `row_range`: x itself on a
    mesh with one spatial rank."""
    if mesh.spatial_size == 1:
        return x
    lo, hi = row_range(x.shape[axis], mesh.spatial_size, mesh.spatial_index)
    return x.narrow(axis, lo, hi - lo)


def row_sharded_forward(model: nn.Module, x: torch.Tensor, mesh) -> Dict[str, torch.Tensor]:
    """model(x) for a network that maps a (B, C, H, W) batch to a dict of
    maps at one resolution (KFPN's and the deconv arch's heads), computed
    on this rank's rows of x and gathered whole on every rank of the
    spatial group in one exchange."""
    with row_sharded(mesh, *x.shape[-2:]):
        out = model(shard_rows(mesh, x))
        whole = gather_channels(list(out.values()))
    return dict(zip(out, whole))


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------


def _is_own(request: Rows, own: Rows) -> bool:
    return tuple(request) == own or (request[1] <= request[0] and own[1] <= own[0])


def _overlap(a: int, b: int, lo: int, hi: int) -> Optional[Rows]:
    lo, hi = max(a, lo), min(b, hi)
    return (lo, hi) if hi > lo else None


def _transport(sends: List[Tuple[int, torch.Tensor]], recvs: List[Tuple[int, torch.Tensor]],
               sh: RowSharding) -> None:
    """Send each (spatial index, tensor) of `sends` and fill each buffer of
    `recvs` from its spatial index, by the group's backend: NCCL batches
    point-to-point operations (`dist.batch_isend_irecv`); gloo sends CPU
    tensors with isend / irecv and stages CUDA tensors through host memory,
    since it has no point-to-point for CUDA tensors. Any other backend
    raises."""
    if not sends and not recvs:
        return
    EXCHANGES["exchanges"] += 1
    EXCHANGES["messages"] += len(sends)
    EXCHANGES["bytes"] += sum(t.numel() * t.element_size() for _, t in sends)
    backend = dist.get_backend(sh.group)
    if backend == "nccl":
        ops = [dist.P2POp(dist.isend, t, sh.ranks[p], sh.group) for p, t in sends]
        ops += [dist.P2POp(dist.irecv, t, sh.ranks[p], sh.group) for p, t in recvs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return
    if backend != "gloo":
        raise ValueError(f"the row exchange has no route over the {backend!r} backend")
    staged = any(t.device.type != "cpu" for _, t in sends + recvs)
    if staged:
        t0 = time.perf_counter()
        sends = [(p, t.cpu()) for p, t in sends]
        targets, recvs = recvs, [(p, torch.empty(t.shape, dtype=t.dtype)) for p, t in recvs]
        EXCHANGES["staging_s"] += time.perf_counter() - t0
    reqs = [dist.isend(t, sh.ranks[p], group=sh.group) for p, t in sends]
    reqs += [dist.irecv(t, sh.ranks[p], group=sh.group) for p, t in recvs]
    for req in reqs:
        req.wait()
    if staged:
        t0 = time.perf_counter()
        for (_, dst), (_, src) in zip(targets, recvs):
            dst.copy_(src)
        EXCHANGES["staging_s"] += time.perf_counter() - t0


def _fetch(x: torch.Tensor, height: int, requests: Sequence[Rows], pad: float, sh: RowSharding) -> torch.Tensor:
    """Rows requests[me] of the row-sharded x, `pad` outside [0, height)."""
    me = sh.index
    lo, hi = sh.rows(height)
    a, b = requests[me]
    out = x.new_full((*x.shape[:-2], b - a, x.shape[-1]), pad)
    sends, recvs, places = [], [], []
    for q, (qa, qb) in enumerate(requests):
        part = _overlap(qa, qb, lo, hi) if q != me else None
        if part is not None:
            sends.append((q, x[..., part[0] - lo:part[1] - lo, :].contiguous()))
    for p in range(sh.size):
        part = _overlap(a, b, *sh.rows(height, p)) if p != me else None
        if part is not None:
            recvs.append((p, x.new_empty((*x.shape[:-2], part[1] - part[0], x.shape[-1]))))
            places.append(part)
    _transport(sends, recvs, sh)
    own = _overlap(a, b, lo, hi)
    if own is not None:
        out[..., own[0] - a:own[1] - a, :] = x[..., own[0] - lo:own[1] - lo, :]
    for (_, buf), (r0, r1) in zip(recvs, places):
        out[..., r0 - a:r1 - a, :] = buf
    return out


def _fetch_transpose(g: torch.Tensor, height: int, requests: Sequence[Rows], sh: RowSharding,
                     local_shape) -> torch.Tensor:
    """The backward of `_fetch`: the gradient of each fetched row goes back
    to its owner and is added to the owner's rows (pad rows have none)."""
    me = sh.index
    lo, hi = sh.rows(height)
    a, b = requests[me]
    grad = g.new_zeros(local_shape)
    sends, recvs, places = [], [], []
    for p in range(sh.size):
        part = _overlap(a, b, *sh.rows(height, p)) if p != me else None
        if part is not None:
            sends.append((p, g[..., part[0] - a:part[1] - a, :].contiguous()))
    for q, (qa, qb) in enumerate(requests):
        part = _overlap(qa, qb, lo, hi) if q != me else None
        if part is not None:
            recvs.append((q, g.new_empty((*g.shape[:-2], part[1] - part[0], g.shape[-1]))))
            places.append(part)
    _transport(sends, recvs, sh)
    own = _overlap(a, b, lo, hi)
    if own is not None:
        grad[..., own[0] - lo:own[1] - lo, :] += g[..., own[0] - a:own[1] - a, :]
    for (_, buf), (r0, r1) in zip(recvs, places):
        grad[..., r0 - lo:r1 - lo, :] += buf
    return grad


class _FetchRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, height, requests, pad, sh):
        ctx.plan = (height, requests, sh, x.shape)
        return _fetch(x, height, requests, pad, sh)

    @staticmethod
    def backward(ctx, g):
        height, requests, sh, shape = ctx.plan
        return _fetch_transpose(g, height, requests, sh, shape), None, None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, height, sh):
        ctx.rows = sh.rows(height)
        return _fetch(x, height, [(0, height)] * sh.size, 0.0, sh)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.rows
        return g[..., lo:hi, :].contiguous(), None, None


class _EmptyRows(torch.autograd.Function):
    """A map with no rows that stands for a layer's output on a rank that
    owns none of its rows: its inputs get zero gradients, so the backward
    reaches them (and their exchanges) on every rank."""

    @staticmethod
    def forward(ctx, shape, dtype, *inputs):
        ctx.metas = [(t.shape, t.dtype, t.device) for t in inputs]
        return torch.empty(shape, dtype=dtype, device=inputs[0].device)

    @staticmethod
    def backward(ctx, g):
        return (None, None, *[torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.metas])


def fetch_rows(x: torch.Tensor, height: int, requests: Sequence[Rows], pad: float = 0.0,
               sharding: Optional[RowSharding] = None) -> torch.Tensor:
    """Global rows requests[index] = [a, b) of the row-sharded map x of
    `height` rows (this rank's rows of it), from whichever ranks own them;
    rows outside [0, height) are `pad`. Every rank of the group calls it
    with the same `requests` (one (a, b) per spatial index; a == b asks for
    nothing). Differentiable: the backward adds each row's gradient on its
    owner."""
    sh = active_rows() if sharding is None else sharding
    if all(_is_own(requests[q], sh.rows(height, q)) for q in range(sh.size)):
        return x  # every rank asks for its own rows
    if torch.is_grad_enabled() and x.requires_grad:
        return _FetchRows.apply(x, height, tuple(requests), pad, sh)
    return _fetch(x, height, requests, pad, sh)


def gather_rows(x: torch.Tensor, sharding: Optional[RowSharding] = None) -> torch.Tensor:
    """The whole map (every rank's rows) of the row-sharded x, on every rank
    of the group; x itself outside a `row_sharded` context. The backward
    returns the rank's own rows of the gradient."""
    sh = active_rows() if sharding is None else sharding
    if sh is None:
        return x
    height = sh.height(x)
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x, height, sh)
    return _fetch(x, height, [(0, height)] * sh.size, 0.0, sh)


def gather_channels(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """gather_rows of maps with the same rows and width, in one exchange:
    concatenated on the channel axis, gathered, split again."""
    if active_rows() is None:
        return list(tensors)
    whole = gather_rows(torch.cat(list(tensors), 1))
    return list(torch.split(whole, [t.shape[1] for t in tensors], 1))


# ---------------------------------------------------------------------------
# the sharded layers
# ---------------------------------------------------------------------------


def _window(rows: Rows, stride: int, pad: int, kernel: int) -> Rows:
    """The input rows a convolution's output rows [lo, hi) read."""
    lo, hi = rows
    return (lo * stride - pad, (hi - 1) * stride - pad + kernel) if hi > lo else (0, 0)


def _empty(shape, dtype, *inputs) -> torch.Tensor:
    inputs = [t for t in inputs if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _EmptyRows.apply(tuple(shape), dtype, *inputs)
    return torch.empty(shape, dtype=dtype, device=inputs[0].device)


def _conv_dtype(x: torch.Tensor) -> torch.dtype:
    dev = x.device.type
    return torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _check_layer(layer: nn.Module, **want) -> None:
    for name, value in want.items():
        if _pair(getattr(layer, name)) != value:
            raise ValueError(f"the row split has no {type(layer).__name__} with {name}={getattr(layer, name)}")


def conv2d_rows(conv: nn.Conv2d, x: torch.Tensor, sh: RowSharding) -> torch.Tensor:
    """This rank's output rows of `conv` on the row-sharded x."""
    _check_layer(conv, dilation=(1, 1))
    if conv.padding_mode != "zeros" or isinstance(conv.padding, str):
        raise ValueError(f"the row split needs numeric zero padding, not {conv.padding!r} / {conv.padding_mode}")
    height, width = sh.height(x), x.shape[-1]
    (kh, kw), (s, sw), (p, pw) = conv.kernel_size, conv.stride, conv.padding
    out_h, out_w = (height + 2 * p - kh) // s + 1, (width + 2 * pw - kw) // sw + 1
    xf = fetch_rows(x, height, [_window(sh.rows(out_h, q), s, p, kh) for q in range(sh.size)], 0.0, sh)
    sh.register(out_w, out_h)
    lo, hi = sh.rows(out_h)
    if hi == lo:
        return _empty((x.shape[0], conv.out_channels, 0, out_w), _conv_dtype(xf), xf, conv.weight, conv.bias)
    return F.conv2d(xf, conv.weight, conv.bias, conv.stride, (0, pw), conv.dilation, conv.groups)


def max_pool_rows(pool: nn.MaxPool2d, x: torch.Tensor, sh: RowSharding) -> torch.Tensor:
    """This rank's output rows of `pool` on the row-sharded x, the halo
    padded with -inf."""
    _check_layer(pool, dilation=(1, 1))
    if pool.ceil_mode or pool.return_indices:
        raise ValueError("the row split has no max-pool with ceil_mode or return_indices")
    height, width = sh.height(x), x.shape[-1]
    (kh, kw), (s, sw), (p, pw) = _pair(pool.kernel_size), _pair(pool.stride), _pair(pool.padding)
    out_h, out_w = (height + 2 * p - kh) // s + 1, (width + 2 * pw - kw) // sw + 1
    xf = fetch_rows(x, height, [_window(sh.rows(out_h, q), s, p, kh) for q in range(sh.size)], float("-inf"), sh)
    sh.register(out_w, out_h)
    lo, hi = sh.rows(out_h)
    if hi == lo:
        return _empty((*x.shape[:-2], 0, out_w), xf.dtype, xf)
    return F.max_pool2d(xf, (kh, kw), (s, sw), (0, pw))


def conv_transpose_rows(deconv: nn.ConvTranspose2d, x: torch.Tensor, sh: RowSharding) -> torch.Tensor:
    """This rank's output rows of the transposed convolution `deconv` on the
    row-sharded x: the input rows its output rows read (zero outside the
    map), the op with no row padding, then the rows cropped."""
    _check_layer(deconv, dilation=(1, 1), output_padding=(0, 0))
    height, width = sh.height(x), x.shape[-1]
    (kh, kw), (s, sw), (p, pw) = deconv.kernel_size, deconv.stride, deconv.padding
    out_h, out_w = (height - 1) * s - 2 * p + kh, (width - 1) * sw - 2 * pw + kw

    def reads(rows: Rows) -> Rows:  # inputs i with i * s - p + t in [lo, hi) for a tap t in [0, k)
        lo, hi = rows
        return (-((kh - 1 - lo - p) // s), (hi - 1 + p) // s + 1) if hi > lo else (0, 0)

    xf = fetch_rows(x, height, [reads(sh.rows(out_h, q)) for q in range(sh.size)], 0.0, sh)
    sh.register(out_w, out_h)
    lo, hi = sh.rows(out_h)
    if hi == lo:
        return _empty((x.shape[0], deconv.out_channels, 0, out_w), _conv_dtype(xf), xf, deconv.weight, deconv.bias)
    y = F.conv_transpose2d(xf, deconv.weight, deconv.bias, deconv.stride, (0, pw), 0, deconv.groups)
    start = lo - reads((lo, hi))[0] * s + p
    return y[..., start:start + hi - lo, :]


def rows_of_product(x: torch.Tensor, matrix, sh: RowSharding, out_width: int):
    """For out = matrix @ x over the rows of the row-sharded x (`matrix` a
    host (H_out, H) array): (the rows of x that this rank's output rows
    read, fetched, this rank's output rows (lo, hi), the fetched rows
    (a, b)). The output's height is registered at `out_width`."""
    height = sh.height(x)
    out_h = matrix.shape[0]

    def reads(rows: Rows) -> Rows:
        lo, hi = rows
        cols = (matrix[lo:hi] != 0).any(0).nonzero()[0] if hi > lo else ()
        return (int(cols[0]), int(cols[-1]) + 1) if len(cols) else (0, 0)

    requests = [reads(sh.rows(out_h, q)) for q in range(sh.size)]
    xf = fetch_rows(x, height, requests, 0.0, sh)
    sh.register(out_width, out_h)
    return xf, sh.rows(out_h), requests[sh.index]


def upsample_nearest_rows(x: torch.Tensor, sh: RowSharding, upsample) -> torch.Tensor:
    """This rank's rows of the 2x nearest upsample `upsample` (a function of
    a whole map) of the row-sharded x: output row i reads input row i // 2."""
    height, width = sh.height(x), x.shape[-1]
    out_h = 2 * height

    def reads(rows: Rows) -> Rows:
        lo, hi = rows
        return (lo // 2, (hi - 1) // 2 + 1) if hi > lo else (0, 0)

    xf = fetch_rows(x, height, [reads(sh.rows(out_h, q)) for q in range(sh.size)], 0.0, sh)
    sh.register(2 * width, out_h)
    lo, hi = sh.rows(out_h)
    if hi == lo:
        return _empty((*x.shape[:-2], 0, 2 * width), xf.dtype, xf)
    start = lo - 2 * reads((lo, hi))[0]
    return upsample(xf)[..., start:start + hi - lo, :]


class RowConv2d(nn.Conv2d):
    """nn.Conv2d that computes only its rank's output rows inside a
    `row_sharded` context."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sh = active_rows()
        return super().forward(x) if sh is None else conv2d_rows(self, x, sh)


class RowMaxPool2d(nn.MaxPool2d):
    """nn.MaxPool2d that computes only its rank's output rows inside a
    `row_sharded` context."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sh = active_rows()
        return super().forward(x) if sh is None else max_pool_rows(self, x, sh)


class RowConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d that computes only its rank's output rows inside a
    `row_sharded` context."""

    def forward(self, x: torch.Tensor, output_size=None) -> torch.Tensor:
        sh = active_rows()
        return super().forward(x, output_size) if sh is None else conv_transpose_rows(self, x, sh)
