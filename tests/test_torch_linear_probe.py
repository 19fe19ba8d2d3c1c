"""The port's linear probe against the JAX package's: the top-k meter, the
probe (weight decay then SGD with momentum, zero init) on the same
features giving the same top-1/top-5, and the eval-mode trunk's features
from the same SwAV weights and running statistics."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.collaborative.optimizer import _named_to_tree
from dedloc_tpu.data.multicrop import synthetic_labeled_images
from dedloc_tpu.finetune import linear_probe as jprobe
from dedloc_tpu.models.swav import SwAVConfig as JaxSwAVConfig
from dedloc_tpu.models.swav import SwAVModel as JaxSwAVModel
from dedloc_tpu_torch.finetune import (
    LinearProbeArguments,
    TopKMeter,
    extract_features,
    run_linear_probe,
)
from dedloc_tpu_torch.finetune.linear_probe import swav_trunk_apply
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.models.resnet import init_batch_stats, init_weights
from dedloc_tpu_torch.models.swav import SwAVConfig, SwAVModel

# the probe's weights after the same SGD steps differ only by fp32 rounding
# (softmax and matmul order): the eval logits within 1e-5 relative of the
# largest |ref|, so the top-k sets agree exactly
LOGIT_RTOL = 1e-5
# the trunk features in eval mode, bf16 convolutions on both sides (the JAX
# package's own ``extract_features``, jitted with XLA's excess precision):
# 2e-2 relative of the largest |ref|, as tests/test_torch_resnet.py
FEAT_RTOL = 2e-2


def test_topk_meter():
    logits = np.array([
        [0.1, 0.9, 0.0, 0.0],
        [0.8, 0.1, 0.05, 0.05],
        [0.0, 0.0, 0.0, 1.0],
    ])
    labels = np.array([1, 2, 3])
    meter = TopKMeter(ks=(1, 3))
    meter.update(logits, labels)
    v = meter.value()
    assert v["top_1"] == pytest.approx(2 / 3)
    assert v["top_3"] == pytest.approx(3 / 3)
    meter.update(logits, labels)
    assert meter.total == 6


@pytest.mark.parametrize("noise", [0.05, 1.0])
def test_probe_matches_jax_on_the_same_features(noise):
    """Separable (noise 0.05) and hard (noise 1.0) features: the same
    top-1/top-5 as the JAX probe, 6 classes."""
    rng = np.random.default_rng(0)
    n, d, classes = 256, 16, 6
    labels = rng.integers(0, classes, n).astype(np.int32)
    feats = rng.standard_normal((n, d)).astype(np.float32) * noise
    feats[np.arange(n), labels] += 1.0
    args = dict(num_epochs=5, batch_size=32, learning_rate=0.5)
    want = jprobe.run_linear_probe(feats[:192], labels[:192], feats[192:], labels[192:],
                                   classes, jprobe.LinearProbeArguments(**args))
    got = run_linear_probe(feats[:192], labels[:192], feats[192:], labels[192:],
                           classes, LinearProbeArguments(**args), device="cpu")
    assert got == want
    if noise < 0.1:
        assert got["top_1"] > 0.9


def test_probe_weights_track_jax():
    """The probe's eval logits (through the meter's inputs) after a few
    epochs: the port's and the JAX package's within LOGIT_RTOL."""
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((96, 8)).astype(np.float32)
    labels = rng.integers(0, 3, 96).astype(np.int32)
    captured = {}
    orig = TopKMeter.update

    def spy(self, logits, labels_):
        captured.setdefault("port", logits)
        return orig(self, logits, labels_)

    jorig = jprobe.TopKMeter.update

    def jspy(self, logits, labels_):
        captured.setdefault("jax", logits)
        return jorig(self, logits, labels_)

    args = dict(num_epochs=3, batch_size=16, learning_rate=0.2, weight_decay=1e-3)
    try:
        TopKMeter.update, jprobe.TopKMeter.update = spy, jspy
        jprobe.run_linear_probe(feats, labels, feats, labels, 3,
                                jprobe.LinearProbeArguments(**args))
        run_linear_probe(feats, labels, feats, labels, 3,
                         LinearProbeArguments(**args), device="cpu")
    finally:
        TopKMeter.update, jprobe.TopKMeter.update = orig, jorig
    ref = np.asarray(captured["jax"], np.float64)
    np.testing.assert_allclose(captured["port"], ref, rtol=LOGIT_RTOL,
                               atol=LOGIT_RTOL * np.abs(ref).max())


def test_swav_trunk_features_match_jax_and_probe():
    """The eval-mode trunk of the same SwAV weights and running statistics:
    features within FEAT_RTOL of JAX's, and the probe on them beats
    chance."""
    jmodel = JaxSwAVModel(JaxSwAVConfig.tiny())
    size = 16
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), [jnp.zeros((2, size, size, 3))], True))
    model = init_weights(SwAVModel(SwAVConfig.tiny()), torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    stats = init_batch_stats(model)
    # running statistics away from the initial 0 / 1
    g = torch.Generator().manual_seed(1)
    stats = {k: (v + 0.1 * torch.rand(v.shape, generator=g)) for k, v in stats.items()}
    jparams = _named_to_tree(convert.params_to_jax(params), shapes["params"])
    jstats = _named_to_tree(convert.params_to_jax(stats), shapes["batch_stats"])
    images, labels = synthetic_labeled_images(96, size=size, num_classes=4, seed=1)
    jfeats = jprobe.extract_features(
        jprobe.swav_trunk_apply(jmodel, jparams, jstats), images[:32], batch_size=32)
    apply_fn = swav_trunk_apply(model, params, stats)
    feats = extract_features(apply_fn, images, batch_size=40, device="cpu")
    assert feats.shape == (96, SwAVConfig.tiny().trunk.out_features)
    np.testing.assert_allclose(feats[:32], jfeats, rtol=FEAT_RTOL,
                               atol=FEAT_RTOL * np.abs(jfeats).max())
    result = run_linear_probe(feats[:64], labels[:64], feats[64:], labels[64:], 4,
                              LinearProbeArguments(num_epochs=15, batch_size=32,
                                                   learning_rate=0.3), device="cpu")
    assert result["top_1"] > 0.5  # 4-way chance = 0.25
