"""The port's slice mesh (``parallel/mesh.py``): layout and placement as the
JAX package's ``make_mesh`` (shapes, errors, ``mesh_shape_for``), and on 4
gloo ranks of a (data=2, model=2) mesh each collective forward and backward
against numpy, ``put_batch`` over data and seq, the slice-wide finite
verdict and the refusals of a mesh the process group cannot hold."""
import numpy as np
import pytest
import torch

from dedloc_tpu.parallel.sharding import mesh_shape_for as jax_mesh_shape_for
from dedloc_tpu_torch.parallel import mesh as M
from dedloc_tpu_torch.parallel.sharding import mesh_shape_for
from torch_mesh_ranks import run_ranks

NAMES = ["psum_data", "psum_both", "pmean_model", "copy_to_data",
         "gather_model", "ppermute_ring", "ppermute_shift"]


def _coords(rank):
    return rank // 2, rank % 2  # (data, model), row-major


def _rank(data, model):
    return data * 2 + model


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(0)
    inputs = {"x": rng.normal(size=(4, 3, 5)).astype(np.float32),
              "w": rng.normal(size=(4, 3, 5)).astype(np.float32),
              "batch": {"input_ids": np.arange(32).reshape(4, 8).astype(np.int32),
                        "sop_labels": np.arange(4).astype(np.int32)}}
    for name in NAMES:
        shape = (4, 3, 10) if name == "gather_model" else (4, 3, 5)
        inputs["w_" + name] = rng.normal(size=shape).astype(np.float32)
    out = run_ranks(tmp_path_factory.mktemp("mesh"), 4, "collectives", inputs)
    return inputs, out


def _expected(name, inputs, rank):
    """(forward, gradient of sum(y * w)) of ``name`` on ``rank``."""
    x, w = inputs["x"], inputs["w_" + name]
    d, m = _coords(rank)
    other_d, other_m = _rank(1 - d, m), _rank(d, 1 - m)
    if name == "psum_data":
        return x[rank] + x[other_d], w[rank]
    if name == "psum_both":
        return x.sum(0), w[rank]
    if name == "pmean_model":
        return (x[rank] + x[other_m]) / 2, w[rank] / 2
    if name == "copy_to_data":
        return x[rank], w[rank] + w[other_d]
    if name == "gather_model":
        y = np.concatenate([x[_rank(d, 0)], x[_rank(d, 1)]], axis=1)
        return y, w[rank][:, m * 5:(m + 1) * 5]
    if name == "ppermute_ring":
        return x[other_d], w[other_d]
    if name == "ppermute_shift":  # model 0 -> model 1; model 0 gets zeros
        if m == 1:
            return x[other_m], np.zeros_like(x[rank])
        return np.zeros_like(x[rank]), w[other_m]
    raise KeyError(name)


@pytest.mark.parametrize("name", NAMES)
def test_collective_forward_and_backward_match_numpy(ranks, name):
    inputs, out = ranks
    for rank, o in enumerate(out):
        y, g = o[name]
        want_y, want_g = _expected(name, inputs, rank)
        np.testing.assert_allclose(y, want_y, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g, want_g, rtol=1e-6, atol=1e-6)


def test_ranks_sit_row_major_on_a_gloo_mesh(ranks):
    _inputs, out = ranks
    for rank, o in enumerate(out):
        d, m = _coords(rank)
        assert o["coords"] == {"data": d, "model": m}
        assert o["backend"] == "gloo"


def test_bf16_gathers_bit_exact(ranks):
    inputs, out = ranks
    x = torch.from_numpy(inputs["x"]).to(torch.bfloat16).float().numpy()
    for rank, o in enumerate(out):
        d, m = _coords(rank)
        want = np.concatenate([x[_rank(0, m)], x[_rank(1, m)]], axis=0)
        np.testing.assert_array_equal(o["gather_bf16"], want)


def test_finite_verdict_is_the_slices(ranks):
    _inputs, out = ranks
    assert all(o["finite"] for o in out)
    # one NaN on rank 3 rejects the update on every rank
    assert not any(o["finite_one_nan"] for o in out)


def test_put_batch_takes_this_ranks_rows_and_sequence_chunk(ranks):
    inputs, out = ranks
    ids = inputs["batch"]["input_ids"]
    for rank, o in enumerate(out):
        d, c = _coords(rank)  # (data, seq) on the second mesh
        np.testing.assert_array_equal(o["put_batch"]["input_ids"],
                                      ids[2 * d:2 * d + 2, 4 * c:4 * c + 4])
        np.testing.assert_array_equal(o["put_batch"]["sop_labels"],
                                      inputs["batch"]["sop_labels"][2 * d:2 * d + 2])


def test_a_mesh_the_world_cannot_hold_is_refused(ranks):
    _inputs, out = ranks
    for o in out:
        assert "torch.distributed.run --nproc_per_node 2" in o["errors"]["world"]
        assert "does not hold 4 devices" in o["errors"]["shape"]


def test_make_mesh_rejects_out_of_range_offset():
    with pytest.raises(ValueError, match="exceeds"):
        M.make_mesh(4, device_offset=8, device_type="cpu")


def test_one_device_mesh_needs_no_process_group():
    mesh = M.make_mesh(1, ("data", "model"), device_type="cpu")
    assert dict(mesh.shape) == {"data": 1, "model": 1}
    assert mesh.group("data") is None
    x = torch.ones(3, requires_grad=True)
    assert M.psum(x, mesh, "data") is x


@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_shape_for_matches_jax(n):
    assert mesh_shape_for(n) == jax_mesh_shape_for(n)


def test_layout_groups_are_row_major():
    layout = M.MeshLayout(("data", "model", "seq"), (2, 2, 2))
    assert layout.coords(5) == {"data": 1, "model": 0, "seq": 1}
    assert layout.group_ranks("data", 5) == [1, 5]
    assert layout.group_ranks(("data", "seq"), 5) == [0, 1, 4, 5]
    assert layout.all_groups("model") == [[0, 2], [1, 3], [4, 6], [5, 7]]


@pytest.mark.parametrize("n,offset,device,cards,backend,indices", [
    (2, 0, "cpu", 1, "gloo", None),
    (2, 0, "cuda", 1, "gloo", [0, 0]),   # two ranks share the one card
    (2, 0, "cuda", 2, "nccl", [0, 1]),   # a card per rank
    (2, 1, "cuda", 4, "nccl", [1, 2]),   # device_offset, as JAX's
    (4, 2, "cuda", 4, "gloo", [2, 3, 2, 3]),
])
def test_placement_picks_devices_and_backend(n, offset, device, cards, backend,
                                             indices):
    devices, got = M.placement(n, offset, device, cards)
    assert got == backend
    if indices is None:
        assert all(d.type == "cpu" for d in devices)
    else:
        assert [d.index for d in devices] == indices


def test_placement_refuses_an_offset_past_the_cards():
    with pytest.raises(ValueError, match="exceeds"):
        M.placement(2, 1, "cuda", 1)
