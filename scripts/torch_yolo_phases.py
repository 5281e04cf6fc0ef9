"""Run only the YOLOv8 training and evaluation phases of `chip_smoke.py` on
one NVIDIA GPU: the card and the kernel build, then yolo_train_parity, a
64-frame synthetic mini-KITTI with camera frames (the train phase's), and
yolo_train, yolo_eval and kitti_eval, each printing its JSON line.

    python3 scripts/torch_yolo_phases.py

It is the quick way to iterate on those phases (about 90 s of command time
against chip_smoke.py's full run), and it times the YOLO steps on a card
that has not just trained KFPN. Exits non-zero when a phase fails.
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
    chip_smoke.phase_yolo_train_parity(card)
    with tempfile.TemporaryDirectory() as tmp:
        root = write_mini_kitti(os.path.join(tmp, "kitti"), n_frames=chip_smoke.TRAIN_FRAMES, seed=chip_smoke.SEED,
                                splits={"train": range(chip_smoke.TRAIN_FRAMES),
                                        "val": range(chip_smoke.TRAIN_VAL_FRAMES)})
        val, _, best = chip_smoke.phase_yolo_train(card, root, os.path.join(tmp, "yolo"))
        chip_smoke.phase_yolo_eval(card, val, best)
        chip_smoke.phase_kitti_eval(card, root, tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
