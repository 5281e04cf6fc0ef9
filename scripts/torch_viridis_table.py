"""Derive the port's viridis colour table from matplotlib and check (or
write) the constant that `sfa3d_tpu_torch/viz/bev_projection.py` holds and
`sfa3d_tpu_torch/viz/kfpn_viz.py` colours its panels with.

    python scripts/torch_viridis_table.py [--write]

matplotlib's `viridis` has 256 entries; `imshow` maps a value normalised
to [0, 1] to entry floor(x * 256) (1.0 to the last). The table is each
entry's RGB in [0, 1] times 255, rounded, stored as B, G, R bytes. Without
`--write` the script only compares the committed table with matplotlib's
and exits non-zero when they differ. This script may import matplotlib;
the package may not.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import matplotlib
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
TARGET = os.path.join(ROOT, "sfa3d_tpu_torch", "viz", "bev_projection.py")


def viridis_bgr() -> np.ndarray:
    cmap = matplotlib.colormaps["viridis"]
    assert cmap.N == 256
    rgb = np.round(cmap(np.arange(256))[:, :3] * 255).astype(np.uint8)
    return np.ascontiguousarray(rgb[:, ::-1])


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--write", action="store_true", help="rewrite the committed table")
    args = p.parse_args()
    table = viridis_bgr()
    if args.write:
        hexed = table.tobytes().hex()
        lines = "\n".join(f'    "{hexed[i:i + 96]}"' for i in range(0, len(hexed), 96))
        src = open(TARGET).read()
        src = re.sub(r"_VIRIDIS_HEX = \(\n.*?\n\)", "_VIRIDIS_HEX = (\n" + lines + "\n)", src, count=1, flags=re.S)
        with open(TARGET, "w") as f:
            f.write(src)
        print(f"wrote {TARGET}")
    from sfa3d_tpu_torch.viz.bev_projection import VIRIDIS_BGR

    same = np.array_equal(VIRIDIS_BGR, table)
    print(f"viridis: the committed table {'equals' if same else 'DIFFERS from'} matplotlib {matplotlib.__version__}'s")
    sys.exit(0 if same else 1)


if __name__ == "__main__":
    main()
