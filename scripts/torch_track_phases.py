"""Run only the tracking and serve-CLI phases of `chip_smoke.py` on one
NVIDIA GPU: the card and the kernel build, then track_kernels, track and
serve_cli, each printing its JSON line, and `nvcc -Xptxas -v`'s registers
and spills of the association kernel.

    python3 scripts/torch_track_phases.py

It is the quick way to iterate on those phases against chip_smoke.py's
full run. Exits non-zero when a phase fails.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from sfa3d_tpu_torch import _build  # noqa: E402


def ptxas_report() -> str:
    """nvcc -Xptxas -v on csrc/track_associate.cu: registers, shared memory
    and spills of each kernel."""
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.path.join(tmp, "lib.so"),
             str(_build.CSRC_DIR / "track_associate.cu")],
            capture_output=True, text=True, timeout=300, check=True)
    return "\n".join(line for line in (res.stdout + res.stderr).splitlines() if "ptxas" in line or "spill" in line)


def main() -> int:
    card = chip_smoke.phase_device()
    chip_smoke.phase_build(card)
    print(ptxas_report(), flush=True)
    rec = chip_smoke.phase_track_kernels(card)
    chip_smoke.phase_track(card)
    with tempfile.TemporaryDirectory() as tmp:
        _, rec["launches"] = chip_smoke.phase_serve_cli(card, tmp)
    chip_smoke.emit({"kernels": [rec]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
