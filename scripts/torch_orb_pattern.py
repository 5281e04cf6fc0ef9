"""Read ORB's rBRIEF sampling pattern from the installed cv2 and check it
against `sfa3d_tpu_torch/slam/orb.py::BIT_PATTERN_31`.

    python scripts/torch_orb_pattern.py [--print]

OpenCV's ORB keeps its 31 x 31 pattern as the int32 table `bit_pattern_31_`
(512 points, 256 pairs, values in [-13, 12]) inside the cv2 library. The
script finds it by its first eight values (8, -3, 9, 5, 4, 2, 7, -12),
which must occur exactly once, and reads the 1024 values. It then checks
the table by rebuilding cv2's descriptors: for seeded textured images and
the keypoints of `orb.detect`, given angles spread over [0, 360) (the
keypoints' own and three rotations of them), `orb.compute`'s descriptors
must equal the port's descriptor stage (`orb.compute` of the port) with
the table read back, bit for bit; and the table must equal the one
`orb.py` holds. With --print it prints the table in the layout `orb.py`
holds it (16 values a row). It exits non-zero on any failure. This script
may import cv2; the package may not.
"""

from __future__ import annotations

import argparse
import os
import sys

import cv2
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HEAD = (8, -3, 9, 5, 4, 2, 7, -12)


def read_pattern() -> np.ndarray:
    """The (512, 2) int32 table from the cv2 library's bytes."""
    lib = os.path.join(os.path.dirname(cv2.__file__), "cv2.abi3.so")
    if not os.path.isfile(lib):
        candidates = [f for f in os.listdir(os.path.dirname(cv2.__file__)) if f.startswith("cv2") and ".so" in f]
        if not candidates:
            raise SystemExit(f"no cv2 library next to {cv2.__file__}")
        lib = os.path.join(os.path.dirname(cv2.__file__), candidates[0])
    data = open(lib, "rb").read()
    needle = np.array(HEAD, "<i4").tobytes()
    first = data.find(needle)
    if first < 0 or data.find(needle, first + 1) >= 0:
        raise SystemExit(f"{lib}: the pattern's head occurs {data.count(needle)} times, expected once")
    table = np.frombuffer(data[first:first + 4096], "<i4").astype(np.int32).reshape(512, 2)
    if table.min() < -13 or table.max() > 12:
        raise SystemExit(f"values outside [-13, 12]: {table.min()}..{table.max()}")
    return table


def textured(seed, shape=(300, 420)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (shape[0] // 4, shape[1] // 4)).astype(np.uint8)
    return cv2.GaussianBlur(cv2.resize(img, shape[::-1], interpolation=cv2.INTER_CUBIC), (3, 3), 0)


def check(table: np.ndarray) -> int:
    from sfa3d_tpu_torch.slam import orb

    saved = orb.BIT_PATTERN_31
    orb.BIT_PATTERN_31 = table
    failures, total = 0, 0
    try:
        cvorb = cv2.ORB_create(5000)
        for seed in range(3):
            img = textured(seed)
            detected = cvorb.detect(img, None)
            for turn in (0.0, 90.0, 181.5, 277.25):
                kps = [cv2.KeyPoint(k.pt[0], k.pt[1], k.size, (k.angle + turn) % 360.0, k.response, k.octave)
                       for k in detected]
                kps, want = cvorb.compute(img, kps)
                pts = np.array([k.pt for k in kps], np.float32)
                _, got = orb.compute(img, pts, [k.octave for k in kps], [k.angle for k in kps], device="cpu")
                bad = int((got.numpy() != want).any(1).sum())
                total += len(kps)
                failures += bad
                print(f"image {seed} turn {turn:6.2f}: {len(kps)} keypoints, {bad} descriptors differ")
    finally:
        orb.BIT_PATTERN_31 = saved
    print(f"{total - failures}/{total} descriptors equal cv2's")
    if not np.array_equal(table, saved):
        print("the table differs from sfa3d_tpu_torch/slam/orb.py::BIT_PATTERN_31")
        failures += 1
    return failures


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--print", action="store_true", help="print the table in orb.py's layout")
    args = p.parse_args(argv)
    table = read_pattern()
    if args.print:
        flat = table.ravel()
        for row in range(0, flat.size, 16):
            print("    " + ", ".join(str(int(v)) for v in flat[row:row + 16]) + ",")
    failures = check(table)
    if failures:
        raise SystemExit(f"{failures} failures")
    print("ok")


if __name__ == "__main__":
    main()
