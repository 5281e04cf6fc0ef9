"""scripts/torch_generalize_check.py's harness on the CPU, with a stub
trainer in place of the port's training CLI: the kill once the epoch's
checkpoint lands, the --auto_resume relaunch, the parsing of the trainer's
`resumed from ... at epoch N` lines into resume_history, a relaunch that
finds training complete kept apart, and the curve and gate assembled from
the evaluation of every checkpoint. No 608 x 608 training runs here."""

import importlib.util
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

# The stub: the real trainer's checkpoint names, resume log line and
# --auto_resume semantics (resume after the newest checkpoint; a relaunch past
# the last epoch runs nothing), with a pause per epoch so the kill lands mid-run.
STUB = '''
import argparse, glob, os, re, sys, time
p = argparse.ArgumentParser()
p.add_argument("--root-dir", dest="root_dir")
p.add_argument("--num_epochs", type=int)
p.add_argument("--checkpoint_freq", type=int)
p.add_argument("--saved_fn")
p.add_argument("--auto_resume", action="store_true")
args, _ = p.parse_known_args(sys.argv[1:])
ckpts = os.path.join(args.root_dir, "checkpoints", args.saved_fn)
logs = os.path.join(args.root_dir, "logs", args.saved_fn)
os.makedirs(ckpts, exist_ok=True)
os.makedirs(logs, exist_ok=True)
log = open(os.path.join(logs, "logger_" + args.saved_fn + ".txt"), "a")
start = 1
found = [int(re.search(r"_(\\d+)\\.pth$", f).group(1)) for f in glob.glob(os.path.join(ckpts, "*.pth"))]
if args.auto_resume and found:
    path = os.path.join(ckpts, "Model_%s_epoch_%d.pth" % (args.saved_fn, max(found)))
    log.write("INFO - resumed from %s at epoch %d\\n" % (path, max(found)))
    log.flush()
    start = max(found) + 1
for epoch in range(start, args.num_epochs + 1):
    time.sleep(1.0)
    if epoch % args.checkpoint_freq == 0:
        open(os.path.join(ckpts, "Model_%s_epoch_%d.pth" % (args.saved_fn, epoch)), "wb").write(b"x")
        log.write("INFO - save a checkpoint\\n")
        log.flush()
'''


def _load_script():
    spec = importlib.util.spec_from_file_location("torch_generalize_check",
                                                  ROOT / "scripts" / "torch_generalize_check.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def harness(tmp_path, monkeypatch):
    """The script with the stub trainer and a fake evaluation whose mAP
    follows `curve[epoch]`; the evaluation's argument lists are recorded."""
    import sfa3d_tpu_torch.cli.eval as eval_cli

    mod = _load_script()
    stub = tmp_path / "stub_trainer.py"
    stub.write_text(STUB)
    real_cmd = mod.train_cmd
    cmds = []

    def train_cmd(args, root, tmp):
        cmd = real_cmd(args, root, tmp)
        cmds.append(cmd)
        return [sys.executable, str(stub)] + cmd[cmd.index("train") + 1:]

    calls, curve = [], {}

    def fake_eval(argv):
        calls.append(argv)
        epoch = int(Path(argv[argv.index("--pretrained_path") + 1]).stem.rsplit("_", 1)[1])
        m = curve[epoch]
        return {"mAP": m, "mAOS": m - 0.01, "AP_0": m, "AP_1": m, "AP_2": m,
                "by_difficulty": {"Easy": {"mAP": m + 0.1}, "Moderate": {"mAP": m}, "Hard": {"mAP": m - 0.1}}}

    monkeypatch.setattr(mod, "train_cmd", train_cmd)
    monkeypatch.setattr(eval_cli, "main", fake_eval)
    return mod, cmds, calls, curve


FLAGS = ["--platform", "cpu", "--frames_train", "4", "--frames_val", "2", "--epochs", "4", "--checkpoint_freq", "1",
         "--batch_size", "2", "--effective_batch", "2", "--ema_decay", "0.998", "--ema_tau", "200"]


def test_kill_relaunch_and_curve(harness, tmp_path):
    mod, cmds, calls, curve = harness
    curve.update({1: 0.2, 2: 0.5, 3: 0.7, 4: 0.65})
    out, work = tmp_path / "g.json", tmp_path / "run"
    rc = mod.main(FLAGS + ["--kill_after_epoch", "2", "--kill_delay", "0", "--work_dir", str(work), "--keep_tmp",
                           "--out", str(out)])
    assert rc == 0
    rep = json.loads(out.read_text())
    assert rep["killed_after_epoch"] == 2
    # the kill lands while epoch 3 runs (or just after its checkpoint)
    assert rep["resume_history"] in ([2], [3]) and rep["auto_resumed_from_epoch"] == rep["resume_history"][-1]
    assert rep["relaunches_found_complete_at_epoch"] == []
    assert [r["epoch"] for r in rep["val_map_curve"]] == [1, 2, 3, 4]
    assert rep["best"]["epoch"] == 3 and rep["final"]["epoch"] == 4 and rep["climbed"]
    assert rep["best"]["by_difficulty"]["Easy"] == 0.8 and rep["gate"]["pass"] and rep["gate"]["failures"] == []
    assert rep["config"]["ema_decay"] == 0.998 and rep["work_dir"] == str(work)
    # one command line for both launches: the port's CLI dispatcher, train, strict float32, auto_resume
    assert len(cmds) == 1
    assert cmds[0][1] == "-c" and "allow_tf32 = False" in cmds[0][2] and cmds[0][3] == "train"
    for flag in ("--auto_resume", "--compute_dtype", "--ema_decay", "--platform"):
        assert flag in cmds[0]
    assert "--compilation_cache" not in cmds[0]
    assert all("--use_ema" in a and a[a.index("--split") + 1] == "val" for a in calls)
    assert (work / "kitti" / "ImageSets" / "val.txt").read_text().split() == ["000004", "000005"]

    # a relaunch over the finished run finds training complete: kept apart
    out2 = tmp_path / "g2.json"
    rc = mod.main(FLAGS + ["--resume_tmp", str(work), "--keep_tmp", "--out", str(out2)])
    rep2 = json.loads(out2.read_text())
    assert rc == 0 and rep2["killed_after_epoch"] is None
    assert rep2["resume_history"] == rep["resume_history"]
    assert rep2["relaunches_found_complete_at_epoch"] == [4]
    assert rep2["val_map_curve"] == rep["val_map_curve"]


def test_gate_fails_without_climb_unless_smoke(harness, tmp_path):
    mod, _, _, curve = harness
    curve.update({1: 0.6, 2: 0.5, 3: 0.4, 4: 0.3})
    flags = FLAGS + ["--kill_after_epoch", "0", "--out", str(tmp_path / "g.json")]
    assert mod.main(flags) == 1
    rep = json.loads((tmp_path / "g.json").read_text())
    assert rep["killed_after_epoch"] is None and rep["resume_history"] == []
    assert not rep["climbed"] and not rep["gate"]["pass"]
    assert rep["gate"]["failures"] == ["val mAP did not climb across the curve"]
    assert mod.main(flags + ["--smoke"]) == 0


def test_resume_epochs_reads_every_log_line(tmp_path):
    mod = _load_script()
    logs = tmp_path / "logs" / "gen"
    logs.mkdir(parents=True)
    (logs / "logger_gen.txt").write_text(
        "2026-01-01 - sfa3d_tpu_torch.gen - INFO - auto_resume found /r/Model_gen_epoch_140.pth\n"
        "2026-01-01 - sfa3d_tpu_torch.gen - INFO - resumed from /r/checkpoints/gen/Model_gen_epoch_140.pth at epoch 140\n"
        "2026-01-01 - sfa3d_tpu_torch.gen - INFO - >>> Epoch: [141/200]\n"
        "2026-01-01 - sfa3d_tpu_torch.gen - INFO - resumed from /r/checkpoints/gen/Model_gen_epoch_200.pth at epoch 200\n")
    assert mod.resume_epochs(str(tmp_path)) == [140, 200]
    assert mod.resume_epochs(str(tmp_path / "none")) == []


def test_resume_tmp_refuses_other_flags(harness, tmp_path):
    mod, _, _, _ = harness
    velodyne = tmp_path / "run" / "kitti" / "training" / "velodyne"
    velodyne.mkdir(parents=True)
    (velodyne / "000000.bin").write_bytes(b"")
    with pytest.raises(ValueError, match="holds 1 scenes but the flags say 6"):
        mod.main(FLAGS + ["--resume_tmp", str(tmp_path / "run"), "--out", str(tmp_path / "g.json")])
