"""Device selection for the port's entry points.

Entry points run on `cuda` unless the caller asks for the CPU. A missing GPU
is an error, never a quiet fall back to the CPU.
"""

from __future__ import annotations

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
