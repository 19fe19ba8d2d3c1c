"""The SwAV slice's pieces on gloo ranks against the JAX package on the
CPU: the sinkhorn over 2 and 4 ranks (with and without queue rows, soft
and hard) against JAX's ``sinkhorn_knopp`` on the whole matrix, a batch
norm over 2 ranks against flax's one-device layer (the ``x`` gradient
needs the statistics' cotangent all-reduced, which a backward passing its
per-channel sums through misses), the fused residual variant over 2 ranks
against one rank, and the guarded LARS apply with the prototype
``post_apply`` on 2 ranks against the one-device apply, NaN rollback
included. The accumulate step over 2 and 4 ranks:
``tests/test_torch_swav_mesh_step.py``; the slice peer's CLI:
``tests/test_torch_swav_mesh_role.py``."""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dedloc_tpu.models import swav as jswav
from torch_mesh_ranks import run_ranks

# as tests/test_swav.py holds its sinkhorn: assignments (each <= 1) within
# 1e-5 of JAX's on the whole matrix
SINKHORN_ATOL = 1e-5
# the batch norm's output, running statistics and gradients against
# flax's one-device layer, in fp32
BN_ATOL = 1e-5
B, K, Q = 8, 12, 24


def _sinkhorn_cases():
    rng = np.random.default_rng(0)
    live = (rng.standard_normal((B, K)) * 0.3).astype(np.float32)
    queue = (rng.standard_normal((Q, K)) * 0.3).astype(np.float32)
    return [(live, q, hard) for q in (None, queue) for hard in (False, True)]


@pytest.fixture(scope="module")
def sinkhorn_runs(tmp_path_factory):
    cases = _sinkhorn_cases()
    return {world: run_ranks(tmp_path_factory.mktemp(f"sk{world}"), world,
                             "swav_sinkhorn", {"cases": cases})
            for world in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", range(4), ids=["soft", "hard", "queue_soft",
                                                "queue_hard"])
def test_sinkhorn_over_the_slice_matches_jax(sinkhorn_runs, world, case):
    live, queue, hard = _sinkhorn_cases()[case]
    whole = live if queue is None else np.concatenate([live, queue])
    want = np.asarray(jswav.sinkhorn_knopp(jnp.asarray(whole), 3, 0.05, hard=hard))
    outs = [o[case] for o in sinkhorn_runs[world]]
    got_live = np.concatenate([o[0] for o in outs])
    got_queue = np.concatenate([o[1] for o in outs])  # every queued row once
    got = got_live if queue is None else np.concatenate([got_live, got_queue])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=SINKHORN_ATOL, rtol=0)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)


def _bn_inputs():
    rng = np.random.default_rng(1)
    c = 6
    return dict(x=(rng.standard_normal((B, c, 4, 4)) * 2 + 0.5).astype(np.float32),
                w=rng.standard_normal((B, c, 4, 4)).astype(np.float32),
                weight=(1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                bias=(0.1 * rng.standard_normal(c)).astype(np.float32),
                r=rng.standard_normal((B, c, 4, 4)).astype(np.float32))


def _flax_bn(inputs):
    """flax's BatchNorm (the JAX trunk's) on the whole batch, NHWC: output,
    new running statistics and the gradients of sum(y * w)."""
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      dtype=jnp.float32)
    to_nhwc = lambda a: jnp.asarray(np.transpose(a, (0, 2, 3, 1)))
    x, w = to_nhwc(inputs["x"]), to_nhwc(inputs["w"])
    variables = bn.init(jax.random.PRNGKey(0), x)
    params = {"scale": jnp.asarray(inputs["weight"]), "bias": jnp.asarray(inputs["bias"])}

    def loss(params, x):
        y, mutated = bn.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              x, mutable=["batch_stats"])
        return (y * w).sum(), (y, mutated["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                                   has_aux=True)(params, x)
    back = lambda a: np.transpose(np.asarray(a), (0, 3, 1, 2))
    return dict(y=back(y), gx=back(gx), gw=np.asarray(gp["scale"]),
                gb=np.asarray(gp["bias"]), mean=np.asarray(stats["mean"]),
                var=np.asarray(stats["var"]))


@pytest.fixture(scope="module")
def bn_run(tmp_path_factory):
    inputs = _bn_inputs()
    return _flax_bn(inputs), run_ranks(tmp_path_factory.mktemp("bn"), 2, "swav_bn",
                                       inputs)


@pytest.mark.parametrize("what", ["y", "gx", "gw", "gb", "mean", "var"])
def test_batch_norm_over_the_slice_matches_flax(bn_run, what):
    want, outs = bn_run
    if what in ("y", "gx"):  # this rank's rows
        got = np.concatenate([o[what] for o in outs])
    elif what in ("gw", "gb"):  # each rank's part, summed over the slice
        got = sum(o[what] for o in outs)
    else:  # the slice's statistics, on every rank
        got = outs[0][what]
        assert len({o["stats_digest"] for o in outs}) == 1
    np.testing.assert_allclose(got, want[what], atol=BN_ATOL, rtol=0, err_msg=what)


def test_batch_norm_x_gradient_needs_the_cotangent_all_reduced(bn_run):
    """A pass-through reduction of the statistics gives each rank only its
    own rows' terms of the mean's and variance's cotangents."""
    want, outs = bn_run
    got = np.concatenate([o["gx_passthrough"] for o in outs])
    assert np.abs(got - want["gx"]).max() > 100 * BN_ATOL


@pytest.mark.parametrize("what", ["y", "dx", "dresidual", "dweight", "dbias", "mean",
                                  "var"])
def test_fused_batch_norm_over_the_slice_equals_one_rank(bn_run, what):
    """The fused residual variant (bf16 x, ReLU(residual + .)) on 2 ranks,
    its statistics' sums and its backward's per-channel sums all-reduced,
    against one rank over the same rows: the rows' outputs and gradients,
    the parameters' gradients summed over the ranks, the running
    statistics on every rank. The slice only reorders fp32 sums; dx is
    bf16 (one step of 2^-8 where a value straddles a rounding boundary)."""
    _, outs = bn_run
    want = outs[0]["fused_one_rank"][what]
    parts = [o["fused"][what] for o in outs]
    if what in ("y", "dx", "dresidual"):  # this rank's rows
        got = np.concatenate(parts)
    elif what in ("dweight", "dbias"):  # each rank's part
        got = sum(parts)
    else:
        got = parts[0]
        for p in parts[1:]:
            np.testing.assert_array_equal(p, got)
    tol = 2 ** -7 if what == "dx" else BN_ATOL
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0,
                               err_msg=what)


def _lars_grads():
    """Three steps' mean gradients for the tiny fp32 SwAV's params (port
    names), scaled like real ones."""
    from dedloc_tpu_torch.models.resnet import ResNetConfig
    from dedloc_tpu_torch.models.swav import SwAVConfig, SwAVModel
    import torch

    model = SwAVModel(SwAVConfig.tiny(trunk=ResNetConfig.tiny(dtype=torch.float32)))
    rng = np.random.default_rng(2)
    return [{n: (1e-2 * rng.standard_normal(tuple(p.shape))).astype(np.float32)
             for n, p in model.named_parameters()} for _ in range(3)]


def test_lars_mesh_apply_with_post_apply_equals_one_device(tmp_path):
    outs = run_ranks(tmp_path, 2, "swav_lars", {"seed": 0, "grads": _lars_grads()})
    for o in outs:
        assert o["oks"] == [(True, True)] * 3
        assert o["equal"] == [True] * 3  # bitwise, params and momentum
        # a NaN on one rank: the slice's verdict rolls every rank back
        assert o["nan_ok"] is False and o["rolled_back"]
    assert outs[0]["digest"] == outs[1]["digest"]
