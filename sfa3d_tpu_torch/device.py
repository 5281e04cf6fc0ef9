"""Device selection for the port's entry points.

Entry points run on `cuda` unless the caller asks for the CPU. A missing GPU
is an error, never a quiet fall back to the CPU.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import torch

Device = Optional[Union[str, torch.device]]


def resolve_device(device: Device = None) -> torch.device:
    """None -> cuda. Raises RuntimeError when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    return dev


def device_constant(fn):
    """Cache a function that makes constant tensors on a device (a tensor,
    or a tuple or dict of them), one result per argument tuple, as
    `functools.lru_cache` would, so a pageable host-to-device copy, which
    synchronizes the stream, happens once. A result made while
    `torch.export` traces (fake tensors) is returned but never kept: the
    cache holds only real tensors, which a traced program then takes as
    constants."""
    from torch._subclasses.fake_tensor import is_fake

    cache = {}

    @functools.wraps(fn)
    def cached(*args):
        out = cache.get(args)
        if out is None:
            out = fn(*args)
            leaves = out.values() if isinstance(out, dict) else out if isinstance(out, tuple) else (out,)
            if not any(is_fake(t) for t in leaves):
                cache[args] = out
        return out

    cached.cache_clear = cache.clear
    return cached
