"""The Argoverse raster's bucketed design (`csrc/bev_counts.cu`: histogram,
scatter, reduce) measured against its own variants and the tile design on
one NVIDIA GPU: the choices behind `ops/bev_counts.py::argoverse_band_plan`.

    python3 scripts/torch_argoverse_variants.py

Prints `nvcc -Xptxas -v` for every kernel of csrc/bev_counts.cu, then at 1,
16 and 64 sweeps of 131072 points (chip_smoke's training input) holds the
wrapper bit for bit against the plain version and the tile design, and
prints, in turns (every variant, then every variant in reverse), the device
time of each kernel of
  plan        the wrapper's plan (band rows, bands, chunk)
  rows=R      R rows a band, the plan's chunk
  chunk=C     C points a histogram / scatter block, the plan's bands
  threads=T   reduce blocks of T threads (a library built with
              -DARGOVERSE_REDUCE_THREADS=T), the plan's bands and chunk
  tile        the first design, the tile pass (19-row bands)
and, as a floor for the reduce's writes, the device time of PyTorch's fill
of a tensor the size of the output (`fill_ms`), with the card's name and
power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
from sfa3d_tpu_torch import _build  # noqa: E402
from sfa3d_tpu_torch.ops import bev_counts  # noqa: E402
from torch_loop_phases import ptxas_registers  # noqa: E402

H = W = chip_smoke.ARGO_H
N = chip_smoke.ARGO_N
ROWS = {1: (3, 6, 9), 16: (4, 6, 9), 64: (4, 6, 9)}
CHUNKS = (1024, 2048, 4096, 8192)
THREADS = (256, 1024)  # besides the built-in 512


def main() -> int:
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for rec in ptxas_registers("bev_counts"):
        print(json.dumps({"ptxas": rec}), flush=True)
    smem = bev_counts.shared_memory_limit(dev)
    sms = bev_counts.multiprocessor_count(dev)
    base = bev_counts.load_library("bev_counts", bev_counts._SIGNATURES)
    libs = {t: bev_counts.load_library("bev_counts", bev_counts._SIGNATURES,
                                       flags=(f"-DARGOVERSE_REDUCE_THREADS={t}",)) for t in THREADS}
    tile = bev_counts.tile_plan(16, H, W, bev_counts.ARGOVERSE_BYTES_PER_CELL, smem)
    for b in chip_smoke.ARGO_SHAPES:
        plan = bev_counts.argoverse_band_plan(b, N, H, W, smem, sms)
        cases = chip_smoke.argoverse_kernel_inputs(np.random.default_rng(chip_smoke.SEED + 20 + b), b,
                                                   (plan[0], tile[0]))
        args = tuple(torch.from_numpy(a).to(dev) for a in cases["training"])
        want = bev_counts.argoverse_raster_reduce_plain(*args, H, W)
        got = bev_counts.argoverse_raster_reduce(*args, H, W)
        if not chip_smoke.bits_equal(got, want) or not chip_smoke.bits_equal(chip_smoke.argoverse_tile_direct(*args), want):
            raise AssertionError(f"the wrapper or the tile design differs from the plain version at B = {b}")

        variants = {"plan": (base, plan)}
        for rows in ROWS[b]:
            n_bands = -(-H // rows)
            variants[f"rows={rows}"] = (base, (rows, n_bands, plan[2]))
        for chunk in CHUNKS:
            variants[f"chunk={chunk}"] = (base, (plan[0], plan[1], chunk))
        for t in THREADS:
            variants[f"threads={t}"] = (libs[t], plan)

        def call(lib, p):
            def run():
                out, err = bev_counts.argoverse_band_launch(lib, dev, *args, H, W, p)
                if err != 0:
                    raise RuntimeError(f"plan {p} at B = {b}: launch failed: cudaError {err}")
                return out
            return run

        for name, (lib, p) in variants.items():
            if not chip_smoke.bits_equal(call(lib, p)(), want):
                raise AssertionError(f"variant {name} differs from the plain version at B = {b}")
        del got, want
        order = [*variants, "tile", "tile", *reversed(variants)]
        times = {}
        for name in order:
            if name == "tile":
                ms = chip_smoke.device_ms(lambda: chip_smoke.argoverse_tile_direct(*args))
                times.setdefault(name, []).append({"total": ms})
                continue
            found = chip_smoke.device_kernels(call(*variants[name]), chip_smoke.ARGO_KERNELS)
            times.setdefault(name, []).append(
                {"total": sum(k["device_ms"] for k in found.values()),
                 **{k: v["device_ms"] for k, v in found.items()}})
        bound_ms = chip_smoke.argoverse_bound(b, int((args[0] >= 0).sum().item()))[0]
        out = torch.empty((b, 3, H, W), device=dev)
        fill_ms = chip_smoke.device_ms(lambda: out.fill_(1.0), kernel="FillFunctor")
        del out
        for name, runs in times.items():
            p = variants[name][1] if name in variants else tile
            print(json.dumps({"shape": [b, N], "variant": name, "plan": p, "bound_ms": bound_ms,
                              "fill_ms": fill_ms,
                              "device_ms": [r["total"] for r in runs],
                              "share_of_bound": [bound_ms / r["total"] for r in runs],
                              "by_kernel": runs, "card": smi}), flush=True)
        del args, cases
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
