"""Run only the data x spatial phase of `chip_smoke.py` on one NVIDIA GPU:
the card and the kernel build, then dp_sp (four gloo ranks sharing the card
on make_mesh_2d(2, 2): the row exchange card vs CPU, the float64 parity
check at 64 x 64, the full-width step against one process, the fused
program at batch 8 against one device), printing its JSON line.

    python3 scripts/torch_dpsp_phases.py

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
    card = chip_smoke.phase_device()
    chip_smoke.phase_build(card)
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.phase_dp_sp(card, tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
