"""Run only the training, bfloat16-inference and training-options phases
of `chip_smoke.py` on one NVIDIA GPU: the card and the kernel build, then
train (the KFPN trainer on its 64-frame synthetic mini-KITTI, float32 and
bfloat16 frames/s end to end), bf16_serve (the bfloat16 Detector and
FusedDetector against the float32 ones, ms a batch, one `serve --dtype
bfloat16 --fused` request) and train_options (a deconv step card vs CPU;
a CLI epoch with --arch resnet_18 --imagenet_pretrained --profile_dir),
each printing its JSON line.

    python3 scripts/torch_bf16_options_phases.py

It is the quick way to iterate on those phases against chip_smoke.py's
full run. Exits non-zero when a phase fails.
"""

from __future__ import annotations

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    card = chip_smoke.phase_device()
    chip_smoke.phase_build(card)
    with tempfile.TemporaryDirectory() as tmp:
        root = chip_smoke.phase_train(card, tmp)[3]
        chip_smoke.phase_bf16_serve(card, tmp)
        chip_smoke.phase_train_options(card, tmp, root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
