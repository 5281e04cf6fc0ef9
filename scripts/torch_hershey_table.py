"""Derive the port's FONT_HERSHEY_SIMPLEX table from cv2 and write
`sfa3d_tpu_torch/viz/hershey.py`; read back cv2's LINE_AA tables and JET
colour map and check them against `sfa3d_tpu_torch/viz/raster.py`.

    python scripts/torch_hershey_table.py [--check-only]

cv2 5.x no longer strokes the Hershey polylines for FONT_HERSHEY_SIMPLEX:
it draws an anti-aliased outline font kept inside its binary, regular below
thickness 2 and bold from 2 on, at the pixel size p = round(27.027 *
fontScale). Each glyph lands on a whole pixel (the pen advances by
floor(advance * p) px), so a glyph's coverage depends on (character,
weight, p) only, and cv2 blends it as (bg * (255 - a) + color * a + 127) //
255, glyph after glyph. The table is read back from cv2 itself, for both
weights and every printable ASCII character (32-126), at the pixel sizes of
fontScale 0.4, 0.5, 0.8 and 1.0 (p = 11, 14, 22, 27), the sizes the CLIs draw: the
whole-pixel advance (the step of `cv2.getTextSize`'s width from two copies
of the character to three), the descent (its baseline alone), and, from
`cv2.putText` white on black, the glyph's block of coverage and its offset
from the pen; and the font height at fontScale 1000.

cv2's LineAA weighs the three pixels across a stroke as (slope correction *
filter weight >> 8) & 0xff, by the stroke's slope bin (32) and the pixel's
sub-pixel offset (64), and cv2 5.x blends each pixel twice with that
weight. The script draws 3000 seeded long lines at every slope bin, white
on black and black on white, inverts the twice-blended values of their
middle pixels to the weight, and factors the 32 x 64 weights into the
slope corrections and filter weights that `raster.py` holds.

The check draws every character and 400 seeded strings with
`sfa3d_tpu_torch.viz.raster` and with cv2 at scales 0.4, 0.5, 0.8 and 1.0,
thickness 1 and 2: `get_text_size` must equal `cv2.getTextSize` and
`put_text` must equal `cv2.putText` pixel for pixel; other scales must be
refused. It also requires the LINE_AA tables and the JET table to equal
cv2's and 300 seeded LINE_AA lines at thickness 1, 2 and 3 to equal cv2's
pixel for pixel. It exits non-zero on any failure. This script may import
cv2; the package may not.
"""

from __future__ import annotations

import argparse
import base64
import os
import sys
import zlib

import cv2
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FONT = cv2.FONT_HERSHEY_SIMPLEX
SIZES = (11, 14, 22, 27)  # pixel sizes of fontScale 0.4, 0.5, 0.8, 1.0
SIZE_SCALES = {11: 0.4, 14: 0.5, 22: 0.8, 27: 1.0}
OUT = os.path.join(ROOT, "sfa3d_tpu_torch", "viz", "hershey.py")
CHARS = [chr(c) for c in range(32, 127)]
WEIGHTS = {"regular": 1, "bold": 2}  # the thickness that selects each
XY_SHIFT = 16


def width(text: str, scale: float, thickness: int) -> int:
    return cv2.getTextSize(text, FONT, scale, thickness)[0][0]


def metrics(ch: str, thickness: int, scale: float):
    """(advance, descent) in px at one fontScale."""
    adv = width(ch * 3, scale, thickness) - width(ch * 2, scale, thickness)
    _, baseline = cv2.getTextSize(ch, FONT, scale, thickness)
    return adv, baseline


def font_height() -> int:
    """The pixel size at fontScale 1000."""
    (_, height), _ = cv2.getTextSize("A", FONT, 1000.0, 1)
    return height


def coverage(ch: str, thickness: int, scale: float):
    """(x0, y0, alpha): the glyph's coverage block and its top-left pixel
    relative to the pen's pixel on the baseline."""
    ox, oy = 40, 80
    img = np.zeros((140, 140), np.uint8)
    cv2.putText(img, ch, (ox, oy), FONT, scale, 255, thickness, cv2.LINE_8)
    ys, xs = np.nonzero(img)
    if not len(xs):
        return 0, 0, np.zeros((0, 0), np.uint8)
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    return int(x0 - ox), int(y0 - oy), img[y0:y1, x0:x1].copy()


def write_module(height, table, blocks):
    blob = base64.b64encode(zlib.compress(b"".join(blocks), 9)).decode()
    blob_lines = [blob[i:i + 96] for i in range(0, len(blob), 96)]
    lines = [
        '"""The port\'s FONT_HERSHEY_SIMPLEX, as cv2 5.x draws it: an anti-aliased',
        "outline font (regular below thickness 2, bold from 2), owned by the port",
        "and used by `viz/raster.py`'s `get_text_size` and `put_text`.",
        "",
        "Generated by `scripts/torch_hershey_table.py` from cv2's own `getTextSize`",
        "and `putText`. Per weight and printable ASCII character (32-126) it",
        "holds, at the pixel sizes 11, 14, 22 and 27 (fontScale 0.4, 0.5, 0.8 and",
        "1.0),",
        "the whole-pixel advance, the descent, and the glyph's coverage block:",
        "its top-left pixel relative to the pen's pixel on the baseline, its",
        "size, and its offset in the zlib-compressed coverage bytes. A character",
        "outside 32-126 draws as '?'.",
        '"""',
        "",
        "import base64",
        "import zlib",
        "from functools import lru_cache",
        "",
        "import numpy as np",
        "",
        f"HEIGHT = {height}  # the pixel size is round(HEIGHT / 1000 * fontScale)",
        f"SIZES = {SIZES!r}  # the tabulated pixel sizes",
        "",
        "# weight -> character -> {size: (advance, descent, x0, y0, w, h, offset)}",
        "_TABLE = {",
    ]
    for weight, glyphs in table.items():
        lines.append(f"    {weight!r}: {{")
        for ch, sizes in glyphs.items():
            lines.append(f"        {ch!r}: {sizes!r},")
        lines.append("    },")
    lines += ["}", "", "_COVERAGE = ("]
    lines += [f'    "{b}"' for b in blob_lines]
    lines += [
        ")",
        "",
        "",
        "def weight(thickness: int) -> str:",
        '    return "bold" if thickness >= 2 else "regular"',
        "",
        "",
        "def _entry(ch: str, thickness: int):",
        "    table = _TABLE[weight(thickness)]",
        '    return table.get(ch) or table["?"]',
        "",
        "",
        "def metrics(ch: str, thickness: int, size: int):",
        '    """(advance, descent) of one character in whole pixels at a tabulated',
        '    size."""',
        "    return _entry(ch, thickness)[size][:2]",
        "",
        "",
        "@lru_cache(maxsize=1)",
        "def _blob() -> bytes:",
        '    return zlib.decompress(base64.b64decode("".join(_COVERAGE)))',
        "",
        "",
        "def block(ch: str, thickness: int, size: int):",
        '    """(x0, y0, alpha uint8 (h, w)) of one character at a tabulated size."""',
        "    x0, y0, w, h, offset = _entry(ch, thickness)[size][2:]",
        "    alpha = np.frombuffer(_blob(), np.uint8, count=w * h, offset=offset).reshape(h, w)",
        "    return x0, y0, alpha",
        "",
    ]
    with open(OUT, "w") as f:
        f.write("\n".join(lines))


def check_text() -> int:
    import importlib

    from sfa3d_tpu_torch.viz import hershey, raster

    importlib.reload(hershey)
    rng = np.random.default_rng(0)
    strings = CHARS + ["".join(rng.choice(CHARS, size=rng.integers(1, 24))) for _ in range(400)]
    strings += ["Fused car 0.87", "bayesian fusion  12.3 FPS", "0.53", "github.com/maudzung", "Speed: 42.5 FPS",
                "#12", "(7)"]
    failures = 0
    for text in strings:
        for scale in (0.4, 0.5, 0.8, 1.0):
            for thick in (1, 2):
                size = cv2.getTextSize(text, FONT, scale, thick)
                mine = raster.get_text_size(text, raster.FONT_HERSHEY_SIMPLEX, scale, thick)
                if tuple(size[0]) != tuple(mine[0]) or size[1] != mine[1]:
                    print("size differs", repr(text), scale, thick, size, mine)
                    failures += 1
                w, h = size[0][0] + 20, size[0][1] + size[1] + 20
                a = np.full((h, w, 3), 40, np.uint8)
                b = a.copy()
                org = (10, 10 + size[0][1])
                cv2.putText(a, text, org, FONT, scale, (255, 200, 0), thick, cv2.LINE_8)
                raster.put_text(b, text, org, raster.FONT_HERSHEY_SIMPLEX, scale, (255, 200, 0), thick)
                if not np.array_equal(a, b):
                    print("pixels differ", repr(text), scale, thick, int((a != b).any(2).sum()))
                    failures += 1
    for scale in (0.6, 1.2):
        try:
            raster.get_text_size("0.53", raster.FONT_HERSHEY_SIMPLEX, scale, 1)
            print("scale not refused", scale)
            failures += 1
        except ValueError:
            pass
    print(f"text: checked {len(strings)} strings x 4 scales x 2 thicknesses: {failures} failures")
    return failures


def _blend_twice_inverse():
    """(white-on-black value, black-on-white value) -> the weights a that
    give them when blended twice as bg + (((c - bg) * a + 127) >> 8)."""
    def blend(bg, c, a):
        return bg + (((c - bg) * a + 127) >> 8)

    inv = {}
    for a in range(256):
        key = (blend(blend(0, 255, a), 255, a), blend(blend(255, 0, a), 0, a))
        inv.setdefault(key, []).append(a)
    return inv


def _line_aa_middle(h, w, p1, p2):
    """The middle pixels of cv2's LineAA walk of a 16.16 segment inside the
    image: (slope bin, [(x, y, filter index), ...])."""
    (x1, y1), (x2, y2) = p1, p2
    xmajor = abs(x2 - x1) > abs(y2 - y1)
    u1, v1, u2, v2 = (x1, y1, x2, y2) if xmajor else (y1, x1, y2, x2)
    if u2 < u1:
        u1, v1, u2, v2 = u2, v2, u1, v1
    dv, du = v2 - v1, (u2 - u1) | 1
    step = abs(dv << XY_SHIFT) // du * (1 if dv >= 0 else -1)
    u2 += 1 << XY_SHIFT
    ecount = (u2 >> XY_SHIFT) - (u1 >> XY_SHIFT)
    v1 += ((step * -(u1 & 0xFFFF)) >> XY_SHIFT) + (1 << 15)
    slope = ((step >> 11) & 0x3F) ^ (0x3F if step < 0 else 0)
    out = []
    for n in range(2, ecount - 1):
        v = v1 + n * step
        first, dist = (v >> XY_SHIFT) - 1, (v >> 11) & 31
        for k, idx in enumerate((dist + 32, dist, 63 - dist)):
            x, y = ((u1 >> XY_SHIFT) + n, first + k) if xmajor else (first + k, (u1 >> XY_SHIFT) + n)
            if 0 <= x < w and 0 <= y < h:
                out.append((x, y, idx))
    return slope, out


def derive_aa_tables(trials: int = 3000, seed: int = 0):
    """(slope corrections (32), filter weights (64)) read back from cv2."""
    inv = _blend_twice_inverse()
    rng = np.random.default_rng(seed)
    seen = {}
    h = w = 80
    for trial in range(trials):
        s = (trial % 32 + rng.uniform(0.0, 1.0)) / 32
        du = int(rng.integers(300, 1200))
        dv = int(du * s) * (1 if rng.random() < 0.5 else -1)
        u0, v0 = (3 << 5) + int(rng.integers(0, 32)), (40 << 5) + int(rng.integers(0, 32))
        p1, p2 = ((u0, v0), (u0 + du, v0 + dv)) if rng.random() < 0.5 else ((v0, u0), (v0 + dv, u0 + du))
        up, down = np.zeros((h, w, 3), np.uint8), np.full((h, w, 3), 255, np.uint8)
        cv2.line(up, p1, p2, (255, 255, 255), 1, cv2.LINE_AA, 5)
        cv2.line(down, p1, p2, (0, 0, 0), 1, cv2.LINE_AA, 5)
        slope, pixels = _line_aa_middle(h, w, tuple(v << 11 for v in p1), tuple(v << 11 for v in p2))
        for x, y, idx in pixels:
            seen.setdefault((slope, idx), set()).update(inv[(int(up[y, x, 0]), int(down[y, x, 0]))])
    if len(seen) != 32 * 64:
        raise SystemExit(f"only {len(seen)} of 2048 (slope, offset) weights seen")
    def fits(s, f, k, i):
        return ((s * f) >> 8) & 0xFF in seen[(k, i)]

    for base in range(128, 257):  # the correction of the shallowest slopes
        corr = [{base}] + [set(range(256)) for _ in range(31)]
        filt = [{f for f in range(256) if fits(base, f, 0, i)} for i in range(64)]
        while True:  # narrow both until neither changes
            new_corr = [{s for s in c if all(any(fits(s, f, k, i) for f in filt[i]) for i in range(64))}
                        for k, c in enumerate(corr)]
            new_filt = [{f for f in c if all(any(fits(s, f, k, i) for s in new_corr[k]) for k in range(32))}
                        for i, c in enumerate(filt)]
            if new_corr == corr and new_filt == filt:
                break
            corr, filt = new_corr, new_filt
        if all(len(c) == 1 for c in corr + filt):
            return [min(c) for c in corr], [min(c) for c in filt]
    raise SystemExit("the LINE_AA weights do not factor into slope corrections and filter weights")


def check_aa_and_jet() -> int:
    from sfa3d_tpu_torch.viz import raster

    failures = 0
    corr, filt = derive_aa_tables()
    print("LINE_AA slope corrections:", corr)
    print("LINE_AA filter weights:", filt)
    if tuple(corr) != tuple(raster._AA_SLOPE_CORR) or tuple(filt) != tuple(raster._AA_FILTER.tolist()):
        print("LINE_AA tables differ from raster.py's")
        failures += 1
    rng = np.random.default_rng(1)
    for thickness in (1, 2, 3):
        for _ in range(100):
            x1, y1, x2, y2 = (int(v) for v in rng.integers(-60, 220, 4))
            a = np.full((120, 160, 3), 30, np.uint8)
            b = a.copy()
            cv2.line(a, (x1, y1), (x2, y2), (0, 0, 255), thickness, cv2.LINE_AA)
            raster.line(b, (x1, y1), (x2, y2), (0, 0, 255), thickness, raster.LINE_AA)
            if not np.array_equal(a, b):
                print("LINE_AA differs", (x1, y1, x2, y2), thickness)
                failures += 1
    levels = np.arange(256, dtype=np.uint8).reshape(16, 16)
    if not np.array_equal(raster.apply_colormap_jet(levels), cv2.applyColorMap(levels, cv2.COLORMAP_JET)):
        print("JET differs from cv2's")
        failures += 1
    print(f"LINE_AA and JET: {failures} failures")
    return failures


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--check-only", action="store_true", help="check the committed tables, write nothing")
    args = p.parse_args()
    if not args.check_only:
        table, blocks, offset = {}, [], 0
        for name, thickness in WEIGHTS.items():
            table[name] = {}
            for ch in CHARS:
                sizes = {}
                for size in SIZES:
                    x0, y0, alpha = coverage(ch, thickness, SIZE_SCALES[size])
                    sizes[size] = metrics(ch, thickness, SIZE_SCALES[size]) + (
                        x0, y0, alpha.shape[1], alpha.shape[0], offset)
                    blocks.append(alpha.tobytes())
                    offset += alpha.size
                table[name][ch] = sizes
        write_module(font_height(), table, blocks)
        print(f"wrote {OUT}")
    sys.exit(1 if check_text() + check_aa_and_jet() else 0)


if __name__ == "__main__":
    main()
