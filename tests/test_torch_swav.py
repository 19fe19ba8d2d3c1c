"""The port's SwAV pieces against the JAX package's, from the same numpy
inputs and weights: the sinkhorn, the loss over one and two prototype
heads, the queue, the prototype hooks and the model's names and shapes.
``tests/test_torch_swav_steps.py`` holds the accumulate step against JAX's
with these helpers and tolerances, ``tests/test_torch_lars.py`` the local
fused step with LARS."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.collaborative.optimizer import _named_to_tree, _tree_to_named
from dedloc_tpu.data.multicrop import MultiCropSpec as JaxSpec
from dedloc_tpu.data.multicrop import synthetic_multicrop_batches as jax_batches
from dedloc_tpu.models import swav as jswav
from dedloc_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from dedloc_tpu.parallel.train_step import zeros_like_grads as jax_zeros
from dedloc_tpu_torch.data.multicrop import MultiCropSpec, synthetic_multicrop_batches
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.models import swav
from dedloc_tpu_torch.models.resnet import ResNetConfig, init_batch_stats, init_weights
from dedloc_tpu_torch.parallel.train_step import zeros_like_grads

# the sinkhorn's exps and row/column sums in fp32, summed in different
# orders by the two frameworks: assignments (each <= 1) within 1e-6
SINKHORN_ATOL = 1e-6
# the loss from the same scores: 1e-6 relative
LOSS_RTOL = 1e-6
# the accumulate step in fp32 (trunk, head, sinkhorn, loss, backward):
# gradients within 1e-4 relative of each leaf's largest |ref|, the loss and
# the running statistics within 1e-5
GRAD_RTOL = 1e-4
STEP_ATOL = 1e-5
# a bias ahead of a batch norm has an analytic gradient of 0 (the head's
# ``proj0``): both frameworks hold ~1e-7 of rounding noise there, so the
# gradient check has this absolute floor
GRAD_FLOOR = 1e-6
# the same step with the default bf16 convolutions (the JAX reference
# compiled without excess precision, so its casts round). The sinkhorn
# (scores / 0.05) sharpens bf16 noise: at 4 images both packages' bf16
# gradients are ~0.36 (Frobenius, all leaves) from the fp32 ones and single
# leaves up to 0.68, so leaves are not compared one by one. Checked: the
# whole gradient within 0.2 relative error of JAX's (0.11 measured) and a
# cosine of at least 0.98 (0.994), the losses within 1e-2 relative (5e-4
# and 2.6e-3), the running statistics within 1e-2 relative of their
# largest |ref| (2.5e-3)
BF16_GRAD_REL = 0.2
BF16_GRAD_COS = 0.98
BF16_LOSS_RTOL = 1e-2
BF16_STATS_RTOL = 1e-2
B = 4  # images per micro-batch
NO_EXCESS = {"xla_allow_excess_precision": False}


def _fp32_cfg(jax_side: bool, **kw):
    if jax_side:
        return jswav.SwAVConfig.tiny(
            trunk=JaxResNetConfig.tiny(dtype=jnp.float32), **kw)
    return swav.SwAVConfig.tiny(trunk=ResNetConfig.tiny(dtype=torch.float32), **kw)


def _pair(jcfg, tcfg, seed=0):
    """The port's model with flax's initialisers drawn from ``seed``, and
    the JAX variables carrying the same weights (through the converter, on
    the JAX model's traced structure: nothing is compiled)."""
    jmodel = jswav.SwAVModel(jcfg)
    crops = [jnp.asarray(c) for c in next(jax_batches(JaxSpec.tiny(), B, seed=seed))]
    shapes = jax.eval_shape(lambda c: jmodel.init(jax.random.PRNGKey(0), c, True), crops)
    model = init_weights(swav.SwAVModel(tcfg), torch.Generator().manual_seed(seed))
    stats = init_batch_stats(model)
    variables = {
        "params": _named_to_tree(
            convert.params_to_jax(dict(model.named_parameters())), shapes["params"]),
        "batch_stats": _named_to_tree(convert.params_to_jax(stats),
                                      shapes["batch_stats"]),
    }
    return jmodel, variables, model, stats


def _rel(got, want, rtol, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=max(rtol * np.abs(want).max(), floor))


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("queue_rows", [0, 24])
def test_sinkhorn_matches_jax(hard, queue_rows):
    scores = np.random.default_rng(queue_rows + hard).standard_normal(
        (16 + queue_rows, 10)).astype(np.float32) * 0.3
    want = np.asarray(jswav.sinkhorn_knopp(jnp.asarray(scores), 3, 0.05, hard=hard))
    got = swav.sinkhorn_knopp(torch.from_numpy(scores), 3, 0.05, hard=hard)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=SINKHORN_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy().sum(1), 1.0, atol=1e-5)


@pytest.mark.parametrize("heads, with_queue", [((32,), False), ((32,), True),
                                               ((16, 24), False), ((24, 24), True)])
def test_swav_loss_matches_jax(heads, with_queue):
    jcfg = jswav.SwAVConfig.tiny(num_prototypes=heads)
    tcfg = swav.SwAVConfig.tiny(num_prototypes=heads)
    rng = np.random.default_rng(len(heads))
    scores = [rng.standard_normal((B * jcfg.num_crops, k)).astype(np.float32) * 0.2
              for k in heads]
    queue_scores = None
    if with_queue:
        queue_scores = np.stack([
            rng.standard_normal((len(jcfg.crops_for_assign), 12, k)).astype(np.float32) * 0.2
            for k in heads])
    want = float(jswav.swav_loss(
        [jnp.asarray(s) for s in scores], jcfg,
        None if queue_scores is None else jnp.asarray(queue_scores), with_queue))
    got = float(swav.swav_loss(
        [torch.from_numpy(s) for s in scores], tcfg,
        None if queue_scores is None else torch.from_numpy(queue_scores), with_queue))
    assert got == pytest.approx(want, rel=LOSS_RTOL)


def test_queue_update_and_scores_match_jax():
    jcfg = jswav.SwAVConfig.tiny(queue_length=8)
    tcfg = swav.SwAVConfig.tiny(queue_length=8)
    jq = jswav.SwAVQueue.create(jcfg, jax.random.PRNGKey(0))
    tq = swav.SwAVQueue(torch.tensor(np.asarray(jq.embeddings)))
    emb = np.random.default_rng(0).standard_normal((3 * jcfg.num_crops, 16)).astype(np.float32)
    jq2, tq2 = jq.update(jnp.asarray(emb), jcfg), tq.update(torch.from_numpy(emb), tcfg)
    np.testing.assert_array_equal(tq2.embeddings.numpy(), np.asarray(jq2.embeddings))
    kernel = np.random.default_rng(1).standard_normal((16, 32)).astype(np.float32)
    want = jq2.scores({"prototypes0": {"kernel": jnp.asarray(kernel)}}, jcfg)
    got = tq2.scores({"head.prototypes0.weight": torch.from_numpy(kernel.T.copy())}, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # a fresh queue: uniform within +-1/sqrt(D/3), from the given generator
    fresh = swav.SwAVQueue.create(tcfg, torch.Generator().manual_seed(0))
    assert fresh.embeddings.shape == (2, 8, 16)
    assert float(fresh.embeddings.abs().max()) <= 1 / np.sqrt(16 / 3)


def test_normalize_prototypes_matches_jax():
    kernel = np.random.default_rng(2).standard_normal((16, 32)).astype(np.float32)
    other = np.ones((4, 4), np.float32)
    want = jswav.normalize_prototypes(
        {"head": {"prototypes0": {"kernel": jnp.asarray(kernel)},
                  "proj0": {"kernel": jnp.asarray(other)}}})
    params = {"head.prototypes0.weight": torch.from_numpy(kernel.T.copy()),
              "head.proj0.weight": torch.from_numpy(other)}
    got = swav.normalize_prototypes(params)
    np.testing.assert_allclose(got["head.prototypes0.weight"].numpy().T,
                               np.asarray(want["head"]["prototypes0"]["kernel"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(got["head.prototypes0.weight"].numpy(), axis=1),
                               1.0, atol=1e-6)
    assert got["head.proj0.weight"] is params["head.proj0.weight"]


@pytest.mark.parametrize("step", [0, 1, 312, 313, 314, 400, 10_000])
def test_freeze_prototypes_grads_by_global_step(step):
    grads = {"head.prototypes0.weight": torch.ones(8, 4),
             "head.proj0.weight": torch.ones(4, 4)}
    out = swav.freeze_prototypes_grads(grads, step, 313)
    jout = jswav.freeze_prototypes_grads(
        {"head": {"prototypes0": {"kernel": jnp.ones((4, 8))},
                  "proj0": {"kernel": jnp.ones((4, 4))}}}, jnp.asarray(step), 313)
    assert float(out["head.prototypes0.weight"].sum()) == float(
        jout["head"]["prototypes0"]["kernel"].sum()) == (0.0 if step < 313 else 32.0)
    assert float(out["head.proj0.weight"].sum()) == 16.0


def test_model_names_and_shapes_match_jax():
    jmodel = jswav.SwAVModel(jswav.SwAVConfig.tiny())
    crops = [jnp.asarray(c) for c in next(jax_batches(JaxSpec.tiny(), B, seed=0))]
    shapes = jax.eval_shape(lambda c: jmodel.init(jax.random.PRNGKey(0), c, True), crops)
    model = swav.SwAVModel(swav.SwAVConfig.tiny())
    for collection, ours in (("params", dict(model.named_parameters())),
                             ("batch_stats", init_batch_stats(model))):
        want = {jax.tree_util.keystr(path): tuple(leaf.shape) for path, leaf in
                jax.tree_util.tree_flatten_with_path(shapes[collection])[0]}
        got = {}
        for name, t in ours.items():
            jname, perm = convert.grad_name(name, t.ndim)
            got[jname] = tuple(convert.to_jax_layout(t, perm).shape)
        assert got == want, collection


def _accumulate_both(jcfg, tcfg, compiler_options=None):
    """Two micro-batches through each package's accumulate step with the
    queue on; returns the JAX and the port's (grad_acc, n_acc, stats,
    queue, losses). The JAX step is the package's jitted function, compiled
    with ``compiler_options``."""
    jmodel, variables, model, stats = _pair(jcfg, tcfg)
    jq = jswav.SwAVQueue.create(jcfg, jax.random.PRNGKey(5))
    jstep = jswav.make_swav_accumulate_step(jmodel, jcfg)
    tstep = swav.make_swav_accumulate_step(model, tcfg)
    params = dict(model.named_parameters())
    jga, jn, jbs = jax_zeros(variables["params"]), jnp.zeros([], jnp.int32), variables["batch_stats"]
    tga, tn, tbs = zeros_like_grads(params), 0, stats
    tq = swav.SwAVQueue(torch.tensor(np.asarray(jq.embeddings)))
    batches = jax_batches(JaxSpec.tiny(), B, seed=7)
    compiled = None
    jlosses, tlosses = [], []
    for _ in range(2):
        crops = next(batches)
        args = (variables["params"], jbs, jq, jga, jn, [jnp.asarray(c) for c in crops],
                jnp.zeros([], jnp.int32))
        if compiled is None:
            compiled = jstep.lower(*args, True).compile(compiler_options)
        jga, jn, jbs, jq, jm = compiled(*args)
        tga, tn, tbs, tq, tm = tstep(params, tbs, tq, tga, tn,
                                     [torch.from_numpy(c) for c in crops], 0, True)
        jlosses.append(float(jm["loss"]))
        tlosses.append(float(tm["loss"]))
    return (jga, jn, jbs, jq, jlosses), (tga, tn, tbs, tq, tlosses)


def test_multicrop_copy_yields_the_jax_batches():
    spec = MultiCropSpec.tiny()
    ours, theirs = synthetic_multicrop_batches(spec, 3, seed=4), jax_batches(
        JaxSpec.tiny(), 3, seed=4)
    for _ in range(2):
        for a, b in zip(next(ours), next(theirs)):
            assert a.shape == b.shape and a.tobytes() == b.tobytes()
    assert dataclasses.asdict(MultiCropSpec()) == {"sizes": (224, 96), "counts": (2, 6),
                                                   "channels": 3}
