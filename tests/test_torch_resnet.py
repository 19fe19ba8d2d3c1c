"""The port's ResNet trunk against the JAX package's, from the same weights
and NHWC images: train-mode features and running statistics (flax's
biased variance), eval-mode features, the gradients of a scalar of the
features, the bf16 default, and the converter's exact round trip."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.collaborative.optimizer import _tree_to_named
from dedloc_tpu.models.resnet import ResNet as JaxResNet
from dedloc_tpu.models.resnet import ResNetConfig as JaxConfig
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.models.resnet import ResNet, ResNetConfig, init_batch_stats

# fp32 on both sides: the two frameworks' convolutions and reductions sum
# in different orders, so features agree to ~1e-6 relative; 1e-4 relative
# (of the largest |ref|) leaves room for that and catches any wrong layer
FEAT_RTOL = 1e-4
# the running statistics after one training forward: 1e-5 absolute; the
# unbiased variance would be off by a factor n / (n - 1) (3-7% in the head)
STATS_ATOL = 1e-5
# the default bf16 convolutions: inputs and kernels rounded to bf16 in both
# frameworks, fp32 batch norm; 2e-2 relative of the largest |ref| (2.6e-3
# measured). The JAX reference is compiled without XLA's excess precision,
# so its bf16 casts round as they do on the TPU (with it, XLA on the CPU
# keeps fp32 between a conv and its batch norm)
BF16_RTOL = 2e-2


def _images(n=6, size=32, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _pair(dtype_jax, dtype_torch, images):
    jmodel = JaxResNet(JaxConfig.tiny(dtype=dtype_jax))
    variables = jax.jit(lambda x: jmodel.init(jax.random.PRNGKey(0), x, True))(
        jnp.asarray(images))
    model = ResNet(ResNetConfig.tiny(dtype=dtype_torch))
    model.load_state_dict(convert.params_from_jax(_tree_to_named(variables["params"])))
    stats = convert.params_from_jax(_tree_to_named(variables["batch_stats"]))
    return jmodel, variables, model, stats


def _train_apply(jmodel, **jit_kw):
    """The JAX trunk in training mode, jitted: (variables, images) ->
    (features, mutated batch_stats)."""
    return jax.jit(lambda v, x: jmodel.apply(v, x, True, mutable=["batch_stats"]),
                   **jit_kw)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def fp32():
    images = _images()
    return (images,) + _pair(jnp.float32, torch.float32, images)


def test_batch_stats_names_match_the_jax_tree(fp32):
    _images_, _jm, variables, model, stats = fp32
    assert sorted(stats) == sorted(init_batch_stats(model))
    ours = convert.params_to_jax(init_batch_stats(model))
    theirs = _tree_to_named(variables["batch_stats"])
    assert sorted(ours) == sorted(theirs)
    for name, ref in theirs.items():
        np.testing.assert_array_equal(ours[name], ref)


def test_train_features_and_running_stats_match_jax(fp32):
    images, jmodel, variables, model, stats = fp32
    want, mutated = _train_apply(jmodel)(variables, jnp.asarray(images))
    got, new_stats = model(torch.from_numpy(images), stats, True)
    _close(got.detach().numpy(), want, FEAT_RTOL)
    ref = _tree_to_named(mutated["batch_stats"])
    ours = convert.params_to_jax(new_stats)
    assert sorted(ours) == sorted(ref)
    for name, arr in ref.items():
        np.testing.assert_allclose(ours[name], arr, atol=STATS_ATOL, rtol=0,
                                   err_msg=name)
    # the input dict is left as it was
    for name, t in stats.items():
        assert t.data_ptr() != new_stats[name].data_ptr()


def test_running_variance_is_the_biased_estimate():
    """One BatchNorm's stored variance is 0.9 * 1 + 0.1 * the biased batch
    variance of its input (F.batch_norm would store the unbiased one)."""
    from dedloc_tpu_torch.models.resnet import BatchNorm

    bn = BatchNorm(4)
    bn.stats_name = "bn"
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((5, 4)).astype(np.float32))
    stats = {"bn.mean": torch.zeros(4), "bn.var": torch.ones(4)}
    bn(x, stats, True)
    biased = x.double().var(dim=0, unbiased=False)
    np.testing.assert_allclose(stats["bn.var"].numpy(), 0.9 + 0.1 * biased.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(stats["bn.mean"].numpy(), 0.1 * x.double().mean(0).numpy(),
                               rtol=1e-5, atol=1e-7)


def test_eval_features_use_running_stats(fp32):
    images, jmodel, variables, model, stats = fp32
    # running statistics that are not the initial 0 / 1
    _, mutated = _train_apply(jmodel)(variables, jnp.asarray(images))
    jvars = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
    want = jax.jit(lambda v, x: jmodel.apply(v, x, False))(jvars, jnp.asarray(images[:3]))
    tstats = convert.params_from_jax(_tree_to_named(mutated["batch_stats"]))
    with torch.no_grad():
        got, same = model(torch.from_numpy(images[:3]), tstats, False)
    _close(got.numpy(), want, FEAT_RTOL)
    for name in tstats:
        assert torch.equal(same[name], tstats[name])


def test_gradients_of_the_features_match_jax(fp32):
    images, jmodel, variables, model, stats = fp32
    proj = np.random.default_rng(2).standard_normal(
        (6, ResNetConfig.tiny().out_features)).astype(np.float32)

    def jloss(params):
        feats, _ = jmodel.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                jnp.asarray(images), True, mutable=["batch_stats"])
        return jnp.sum(feats * proj)

    want = _tree_to_named(jax.jit(jax.grad(jloss))(variables["params"]))
    params = dict(model.named_parameters())
    feats, _ = model(torch.from_numpy(images), stats, True)
    (feats * torch.from_numpy(proj)).sum().backward()
    got = convert.params_to_jax({n: p.grad for n, p in params.items()})
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        _close(got[name], ref, FEAT_RTOL)


def test_bf16_default_features_match_jax():
    images = _images(seed=3)
    jmodel, variables, model, stats = _pair(jnp.bfloat16, torch.bfloat16, images)
    apply = _train_apply(jmodel, compiler_options={"xla_allow_excess_precision": False})
    want, _ = apply(variables, jnp.asarray(images))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(images), stats, True)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, BF16_RTOL)


def test_conv_kernels_round_trip_exactly(fp32):
    _images_, _jm, variables, model, _stats = fp32
    named = _tree_to_named(variables["params"])
    back = convert.params_to_jax(convert.params_from_jax(named))
    assert sorted(back) == sorted(named)
    for name, ref in named.items():
        ref = np.asarray(ref)
        assert back[name].dtype == ref.dtype and back[name].shape == ref.shape
        assert back[name].tobytes() == ref.tobytes(), name
    # a conv kernel HWIO is the Conv2d weight OIHW permuted
    w = model.stem_conv.weight.detach().numpy()
    np.testing.assert_array_equal(
        np.transpose(w, (2, 3, 1, 0)), np.asarray(named["['stem_conv']['kernel']"]))
    assert convert.grad_name("stem_conv.weight", 4) == (
        "['stem_conv']['kernel']", (2, 3, 1, 0))
    assert convert.inverse_perm((2, 3, 1, 0)) == (3, 2, 0, 1)


def test_full_width_resnet50_has_the_jax_shapes():
    """ResNet-50's parameter names and shapes, without running it."""
    shapes = jax.eval_shape(
        lambda: JaxResNet(JaxConfig.resnet50()).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), True))
    want = {jax.tree_util.keystr(path): tuple(leaf.shape) for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    got = {}
    for name, p in ResNet(ResNetConfig.resnet50()).named_parameters():
        jname, perm = convert.grad_name(name, p.ndim)
        got[jname] = tuple(convert.to_jax_layout(p, perm).shape)
    assert got == want
    assert sum(int(np.prod(s)) for s in want.values()) == 23_508_032
    assert ResNetConfig.resnet50().out_features == 2048
