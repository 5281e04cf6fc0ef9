"""The port's row sharding (`sfa3d_tpu_torch/spatial.py`) on the CPU: four
spawned gloo ranks, on a 1 x 4 and a 2 x 2 (data x spatial) mesh
(`parallel/mesh.py::make_mesh_2d`).

- `fetch_rows` and `gather_rows`, forward and backward, exactly equal to
  slicing and scatter-add on small-integer float64 maps (every sum exact in
  any order), at heights whose split leaves ranks with one row or none,
  with requests that reach past both ends of the map (the pad rows) and
  ask for nothing;
- every layer the models split (convolutions k1 / k3 / k7 at stride 1 and
  2, max-pools 3 / s2 and 5 / s1 with their -inf halo, both 2x upsamples,
  the k4 / s2 transposed convolution), gathered whole, within 1e-12 of the
  unsharded layer in float64: the output, the input's gradient on each
  rank's rows and the parameters' gradients summed over the spatial group.

The spawned ranks get a timeout and are killed when it runs out.
"""

import pytest
import torch

from sfa3d_tpu_torch.parallel import mesh as pmesh
from sfa3d_tpu_torch.spatial import RowSharding, row_range
from tests._spatial_ranks import EXCHANGE_HEIGHTS, MESHES, _layers, ops_rank

WORLD = 4
SPAWN_TIMEOUT = 240  # s for the four ranks, spawn and torch import included
LAYER_TOL = 1e-12


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks share this process's threads
    try:
        prefix = str(tmp_path_factory.mktemp("spatial") / "ops")
        pmesh.spawn_ranks(ops_rank, WORLD, args=(prefix,), device="cpu", timeout=SPAWN_TIMEOUT)
    finally:
        torch.set_num_threads(threads)
    return [torch.load(f"{prefix}.rank{r}.pt", weights_only=False) for r in range(WORLD)]


def test_row_range_partition():
    for height in (0, 1, 2, 5, 7, 19, 38, 152):
        for parts in (1, 2, 3, 4):
            spans = [row_range(height, parts, i) for i in range(parts)]
            assert spans[0][0] == 0 and spans[-1][1] == height
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            assert all(hi - lo == min(-(-height // parts), max(0, height - lo)) for lo, hi in spans)
    assert [row_range(2, 4, i) for i in range(4)] == [(0, 1), (1, 2), (2, 2), (2, 2)]


def test_row_sharding_checks_heights():
    sh = RowSharding(None, (0, 1, 2, 3), 2, 5, 6)
    assert sh.height(torch.zeros(1, 1, 1, 6)) == 5
    with pytest.raises(ValueError, match="rows \\[4, 5\\) of 5"):
        sh.height(torch.zeros(1, 1, 2, 6))
    with pytest.raises(ValueError, match="no global height"):
        sh.height(torch.zeros(1, 1, 1, 7))
    with pytest.raises(ValueError, match="one height per width"):
        sh.register(6, 4)


def test_make_mesh_2d_needs_its_world():
    mesh = pmesh.make_mesh_2d(1, 1, device="cpu")
    assert (mesh.data_size, mesh.spatial_size, mesh.synced, mesh.loss_group) == (1, 1, False, None)
    with pytest.raises(ValueError, match="process group of 4"):
        pmesh.make_mesh_2d(2, 2, device="cpu")
    x = torch.arange(4 * 5 * 7).reshape(4, 1, 5, 7)
    parts = [pmesh.Mesh2D(4, r, torch.device("cpu"), data=2, spatial=2) for r in range(4)]
    got = [(pmesh.shard_batch(m, x), m) for m in parts]
    for frames, m in got:
        assert torch.equal(frames, x[2 * (m.rank // 2):2 * (m.rank // 2) + 2])
        lo, hi = row_range(5, 2, m.rank % 2)
        assert torch.equal(pmesh.shard_rows(m, frames), frames[..., lo:hi, :])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_fetch_and_gather_rows_are_slicing_and_scatter_add(ranks, mesh):
    rows = {h: [] for h in EXCHANGE_HEIGHTS}
    for r in ranks:
        for height, found in r["meshes"][mesh]["exchange"].items():
            assert found["fetch"], (mesh, r["rank"], height, "fetch_rows")
            assert found["gather"], (mesh, r["rank"], height, "gather_rows")
            rows[height].append(found["rows"])
    if mesh == (1, 4):
        assert rows[2] == [1, 1, 0, 0] and rows[5] == [2, 2, 1, 0]  # ranks with one row and with none


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("layer", list(_layers()))
def test_sharded_layer_equals_the_unsharded_layer(ranks, mesh, layer):
    for r in ranks:
        err = r["meshes"][mesh]["layers"][layer]
        assert err <= LAYER_TOL, (mesh, r["rank"], layer, err)


def test_spawned_ranks_import_no_jax(ranks):
    assert not any(r["jax_imported"] for r in ranks)
