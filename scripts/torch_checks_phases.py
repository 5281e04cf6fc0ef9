"""Run only the checks phase of `chip_smoke.py` on one NVIDIA GPU: the card
and the kernel build, an 8-frame mini-KITTI with camera frames and a
YOLOv8n trained on it for two epochs by the yolo_train CLI (the stand-ins for
the train and yolo_train phases' outputs), then the five ports of the JAX
check scripts at full width and tiny depth, each printing its JSON line.

    python3 scripts/torch_checks_phases.py

It is the quick way to iterate on that phase against chip_smoke.py's full
run. Exits non-zero when the phase fails.
"""

from __future__ import annotations

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    from sfa3d_tpu_torch.cli import yolo_train
    from sfa3d_tpu_torch.data.synthetic import write_mini_kitti

    card = chip_smoke.phase_device()
    chip_smoke.phase_build(card)
    with tempfile.TemporaryDirectory() as tmp:
        root = write_mini_kitti(os.path.join(tmp, "kitti"), n_frames=8)
        yolo_train.main(["--dataset_dir", root, "--epochs", "2", "--warmup_epochs", "1", "--batch_size", "4",
                         "--eval_every", "2",
                         "--checkpoints_dir", os.path.join(tmp, "yolo"), "--seed", str(chip_smoke.SEED)])
        chip_smoke.phase_checks(card, tmp, root, os.path.join(tmp, "yolo", "best.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
