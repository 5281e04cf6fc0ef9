"""Run only the data-parallel and native-reader phases of `chip_smoke.py`
on one NVIDIA GPU: the card and the kernel build, a 64-frame synthetic
mini-KITTI (the train phase's), then dp_train (an SFA3D_DIST world of one
over NCCL, two gloo ranks sharing the card against one process, one CLI
epoch under SFA3D_DIST) and native (the native reader against its numpy
twin; the train loader's wait with and without it), each printing its
JSON line.

    python3 scripts/torch_dp_phases.py

It is the quick way to iterate on those phases against chip_smoke.py's
full run. Exits non-zero when a phase fails.
"""

from __future__ import annotations

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from sfa3d_tpu_torch.data.synthetic import write_mini_kitti  # noqa: E402


def main() -> int:
    card = chip_smoke.phase_device()
    chip_smoke.phase_build(card)
    with tempfile.TemporaryDirectory() as tmp:
        root = write_mini_kitti(os.path.join(tmp, "kitti"), n_frames=chip_smoke.TRAIN_FRAMES, seed=chip_smoke.SEED,
                                splits={"train": range(chip_smoke.TRAIN_FRAMES),
                                        "val": range(chip_smoke.TRAIN_VAL_FRAMES)})
        chip_smoke.phase_dp_train(card, tmp, root)
        chip_smoke.phase_native(card, tmp, root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
