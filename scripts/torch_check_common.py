"""What the port's check scripts (`scripts/torch_*_check.py`) share: the
device a run asks for, strict float32, the card's record and the kernel
entries' launch counters.

- `resolve(platform)`: cuda unless platform is "cpu"; raises without a GPU
  (`device.resolve_device`). It turns TF32 off for cuDNN and matmuls, so
  float32 is strict float32, the port's parity mode.
- `device_record(device)`: the JSON `device` entry of a check's report: the
  platform, and on the card its name and power limit as `nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader` prints them.
- `launches()`: the launch count of every kernel entry of the port, read
  from the wrappers' counters (one a real CUDA launch; none on the CPU).
"""

from __future__ import annotations

import subprocess
from typing import Dict, Optional

import torch


def resolve(platform: Optional[str]) -> torch.device:
    from sfa3d_tpu_torch.device import resolve_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return resolve_device("cpu" if platform == "cpu" else None)


def device_record(device: torch.device) -> Dict[str, object]:
    if device.type != "cuda":
        return {"platform": "cpu"}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        smi = f"nvidia-smi failed: {e}"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "nvidia_smi": smi}


def _entries():
    from sfa3d_tpu_torch.ops import bev_counts, fusion_loops, track_associate

    return (bev_counts.bev_raster_reduce, bev_counts.bev_cell_counts, bev_counts.argoverse_raster_reduce,
            fusion_loops.hard_nms_keep, fusion_loops.soft_nms_gaussian, fusion_loops.greedy_match,
            track_associate.track_associate)


def launches() -> Dict[str, int]:
    return {fn.__name__: int(fn.launches) for fn in _entries()}
