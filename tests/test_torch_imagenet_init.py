"""`--imagenet_pretrained` in the port (`models/port.py::port_torchvision_backbone`,
`load_imagenet_backbone`, `cli.train --imagenet_pretrained`) against the JAX
package's `load_imagenet_backbone`, on the CPU.

torchvision's ResNet keys are the PoseResNet backbone's, so the port's own
ResNet-18 backbone state_dict (BatchNorm statistics drawn at random) plus
`fc.*` stands in for a torchvision ImageNet file, saved to a temporary
`.pth`: no weights enter the repo and nothing is downloaded. Every tensor
of the port's merged state_dict equals JAX's merged variables through the
bridge bit for bit (the merge copies, it computes nothing), for KFPN and
for the deconv arch; the FPN, deconv and head entries keep their init; a
ResNet-50-shaped `layer1.0.conv1.weight` raises ValueError naming the key;
the hub-cache search honours TORCH_HOME; and the training CLI takes the
flags for one step, whose parameters lie within Adam's first step (lr) of
the file's.
"""

import jax
import numpy as np
import pytest
import torch

from sfa3d_tpu.models import create_model as jcreate_model
from sfa3d_tpu.models.port import load_imagenet_backbone as jload_imagenet_backbone
from sfa3d_tpu.pipeline import init_detector as jinit_detector
from sfa3d_tpu_torch.models import create_model
from sfa3d_tpu_torch.models.port import (
    BACKBONE_PREFIXES,
    deconv_state_dict_from_jax,
    load_imagenet_backbone,
    port_torchvision_backbone,
    state_dict_from_jax,
)

HW = (64, 64)


@pytest.fixture(scope="module")
def torchvision_file(tmp_path_factory):
    """A torchvision-layout resnet18 `.pth`: the port's backbone with
    weights from manual_seed(11), BatchNorm affine terms and statistics
    drawn at random, and a classifier `fc.*`."""
    model = create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(11))
    g = torch.Generator().manual_seed(12)
    sd = {}
    for k, v in model.state_dict().items():
        if not k.startswith(BACKBONE_PREFIXES) or k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_var", "bn1.weight", "bn2.weight", "1.weight")) and v.dim() == 1:
            v = 0.5 + torch.rand(v.shape, generator=g)
        elif v.dim() == 1:
            v = 0.1 * torch.randn(v.shape, generator=g)
        sd[k] = v.clone()
    sd["fc.weight"] = torch.randn(1000, 512, generator=g)
    sd["fc.bias"] = torch.zeros(1000)
    path = tmp_path_factory.mktemp("hub") / "resnet18-5c106cde.pth"
    torch.save(sd, path)
    return str(path), sd


@pytest.mark.parametrize("arch", ["fpn_resnet_18", "resnet_18"])
def test_merge_bit_exact_against_jax(torchvision_file, arch):
    path, file_sd = torchvision_file
    bridge = state_dict_from_jax if arch.startswith("fpn") else deconv_state_dict_from_jax
    jm = jcreate_model(arch)
    init = jax.tree_util.tree_map(np.asarray, jinit_detector(jm, jax.random.PRNGKey(0), input_size=HW))
    want = bridge(jax.tree_util.tree_map(np.asarray, jload_imagenet_backbone(init, 18, path)))
    before = bridge(init)
    got = load_imagenet_backbone(before, 18, path)
    assert list(got) == list(before)
    merged = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
        if k.startswith(BACKBONE_PREFIXES):
            assert torch.equal(got[k], file_sd[k]), k
            merged += 1
        else:  # FPN, deconv and heads keep their init
            assert torch.equal(got[k], before[k]), k
    assert merged == len(file_sd) - 2  # every backbone tensor of the file but fc.*
    model = create_model(arch)
    model.load_state_dict(got, strict=True)  # a working model
    out = model.eval()(torch.zeros(1, 3, *HW))
    assert all(torch.isfinite(v).all() for v in out.values())


def test_resnet50_shaped_weight_raises(torchvision_file):
    _, file_sd = torchvision_file
    bad = dict(file_sd)
    bad["layer1.0.conv1.weight"] = torch.zeros(64, 64, 1, 1)  # ResNet-50's 1x1
    sd = create_model("fpn_resnet_18").state_dict()
    with pytest.raises(ValueError, match=r"layer1\.0\.conv1\.weight.*wrong num_layers"):
        port_torchvision_backbone(bad, sd, 18)
    missing = {k: v for k, v in file_sd.items() if k != "layer4.1.bn2.running_var"}
    with pytest.raises(ValueError, match=r"layer4\.1\.bn2\.running_var"):
        port_torchvision_backbone(missing, sd, 18)
    with pytest.raises(ValueError, match="ResNet-34"):
        port_torchvision_backbone(file_sd, sd, 34)


def test_hub_cache_search_honours_torch_home(torchvision_file, tmp_path, monkeypatch):
    path, file_sd = torchvision_file
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    sd = create_model("resnet_18").state_dict()
    with pytest.raises(FileNotFoundError, match="imagenet_weights"):
        load_imagenet_backbone(sd, 18, None)
    hub = tmp_path / "hub" / "checkpoints"
    hub.mkdir(parents=True)
    (hub / "resnet18-5c106cde.pth").write_bytes(open(path, "rb").read())
    got = load_imagenet_backbone(sd, 18, None)
    assert torch.equal(got["layer2.0.downsample.0.weight"], file_sd["layer2.0.downsample.0.weight"])
    with pytest.raises(FileNotFoundError, match="resnet34"):
        load_imagenet_backbone(create_model("fpn_resnet_34").state_dict(), 34, None)


def test_train_cli_imagenet_pretrained_one_step(torchvision_file, tmp_path):
    from sfa3d_tpu_torch.cli.train import main
    from sfa3d_tpu_torch.data.synthetic import write_mini_kitti

    path, file_sd = torchvision_file
    root = write_mini_kitti(str(tmp_path / "kitti"), n_frames=1, cameras=False)
    lr = 1e-3
    main(["--dataset_dir", root, "--root-dir", str(tmp_path / "run"), "--batch_size", "1",
          "--effective_batch", "1", "--num_epochs", "1", "--checkpoint_freq", "1", "--platform", "cpu",
          "--compute_dtype", "float32", "--num_workers", "1", "--no-val", "--saved_fn", "inet",
          "--lr", str(lr), "--imagenet_pretrained", "--imagenet_weights", path])
    log = (tmp_path / "run" / "logs" / "inet" / "logger_inet.txt").read_text()
    assert "initialized backbone from ImageNet resnet18 weights" in log
    payload = torch.load(tmp_path / "run" / "checkpoints" / "inet" / "Model_inet_epoch_1.pth", weights_only=True)
    assert payload["step"] == 1
    sd = payload["state_dict"]
    for k in ("conv1.weight", "layer3.1.conv2.weight", "layer4.0.downsample.1.bias"):
        # Adam's first update moves each parameter by at most about lr
        assert (sd[k] - file_sd[k]).abs().max() <= 1.01 * lr, k
