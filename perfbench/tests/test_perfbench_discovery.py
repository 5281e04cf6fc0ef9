"""Discovery by name: in a copy of the benchmark, a new configuration, a
new system and reference, a new traffic mix, a new end-to-end metric and a
new per-layer metric are added as new files and entries only, and a run of
the new cell finds and uses every one of them; no file that was there is
edited."""

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

FILES = {
    "configs/dummy-config.json": json.dumps({"system": "dummy_system", "reference": "dummy_reference",
                                             "allow_tf32": False, "limits": {"err": 0.5}}),
    "traffic/dummy-mix.json": json.dumps({"driver": "closed_loop", "clients": 2, "pool": 8, "warm": [1],
                                          "sample": 4}),
    "systems/dummy_system.py": """
        from concurrent.futures import Future

        class System:
            def __init__(self, cfg, seed, device, spans):
                self.spans, self.served = spans, 0
            def buckets(self):
                return [1]
            def warm(self, buckets, request):
                pass
            def pool(self, seed, n):
                return list(range(n))
            def submit(self, request):
                with self.spans.span("device_call", bucket=1, frames=1):
                    fut = Future()
                    fut.set_result(2 * request)
                    self.served += 1
                    return fut
            @staticmethod
            def compact(reply):
                return reply
            def counters(self):
                return {"served": self.served}
            def stop(self):
                pass
        """,
    "reference/dummy_reference.py": """
        def check(cfg, seed, pool, samples, device):
            return {"err": max(abs(reply - 2 * i) for i, reply in samples)}
        """,
    "end_to_end/dummy_served.py": """
        def read(ctx):
            return ctx.counters["served"]
        """,
    "metrics/dummy_calls.layer.py": """
        def read(ctx):
            return len(ctx.spans.of("device_call"))
        """,
}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    for rel, text in FILES.items():
        (tmp_path / "perfbench" / rel).write_text(textwrap.dedent(text))
    bench["configs"].append({"name": "dummy-config", "source": "a test", "file": "perfbench/configs/dummy-config.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy-config", "traffic": "dummy-mix",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_served", "unit": "requests", "better": "higher", "bound": 0.1,
                                "source": "host_clock", "workloads": ["dummy-cell"]})
    bench["per_layer"].append({"name": "dummy_calls.layer", "unit": "calls", "better": "higher",
                               "source": "program_span", "layer": "a test", "moves": "dummy_served",
                               "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent("""
        import json, sys, time
        sys.path.insert(0, ".")
        from perfbench.harness import registry
        from perfbench.harness.bench import run_cell
        res = run_cell("dummy-cell", 7, 0.3, False, time.perf_counter(), device="cpu")
        ctx_metric = registry.load_module("metrics", "dummy_calls.layer")
        print(json.dumps({"result": res, "metric_file": ctx_metric.__file__}))
        """)
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    res = out["result"]
    assert res["correct"] and res["checks"]["err"]["value"] == 0
    assert res["metrics"]["dummy_served"]["value"] > 0 and "setup_s" in res["metrics"]
    assert out["metric_file"].startswith(str(tmp_path))
    after = {p: p.read_bytes() for p in before}
    assert after == before
