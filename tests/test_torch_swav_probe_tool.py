"""``dedloc_tpu_torch/tools/swav_probe.py``: its probe reads a tiny SwAV
checkpoint saved by the JAX package and extracts the same eval-mode trunk
features as the JAX package's own ``extract_features`` on the same
labelled texture images (the ``_labeled_split`` both tools share), then
trains the linear classifier and reports the trained and random trunks."""
import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dedloc_tpu.collaborative.optimizer import _tree_to_named
from dedloc_tpu.finetune import linear_probe as jprobe
from dedloc_tpu.models.swav import SwAVConfig as JaxSwAVConfig
from dedloc_tpu.models.swav import SwAVModel as JaxSwAVModel
from dedloc_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from dedloc_tpu_torch.models.swav import SwAVConfig
from dedloc_tpu_torch.tools import swav_probe

# eval-mode trunk features, bf16 convolutions on both sides (the JAX
# package's own ``extract_features``, jitted with XLA's excess precision):
# 2e-2 relative of the largest |ref|, as tests/test_torch_linear_probe.py
FEAT_RTOL = 2e-2
CLASSES, PER_CLASS, SIZE = 4, 5, 32


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A tiny SwAV state as the JAX swav role checkpoints it, and the JAX
    features of the probe's images."""
    out = str(tmp_path_factory.mktemp("jax_swav"))
    model = JaxSwAVModel(JaxSwAVConfig.tiny(queue_length=0))
    variables = jax.jit(lambda key: model.init(
        key, [np.zeros((2, 32, 32, 3), np.float32)], True))(jax.random.PRNGKey(5))
    host = jax.device_get((variables["params"], variables["batch_stats"]))
    jax_save_checkpoint(out, 7, _tree_to_named(host), metadata={"local_step": 7})
    images, labels = swav_probe._labeled_split(CLASSES, PER_CLASS, SIZE, 11)
    feats = jprobe.extract_features(
        jprobe.swav_trunk_apply(model, variables["params"], variables["batch_stats"]),
        images, batch_size=8)
    return out, images, labels, np.asarray(feats)


def test_probe_features_match_the_jax_tool_on_a_jax_checkpoint(jax_checkpoint):
    ckpt, images, labels, want = jax_checkpoint
    out = swav_probe.probe_checkpoint(ckpt, images, labels, CLASSES,
                                      cfg=SwAVConfig.tiny(queue_length=0),
                                      batch_size=8, device="cpu")
    got = out["features"]
    assert out["checkpoint_step"] == 7
    assert got.shape == want.shape == (CLASSES * PER_CLASS, want.shape[1])
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=FEAT_RTOL * scale, rtol=0)
    for tag in ("random_trunk", "trained_trunk"):
        # top-k with k = min(5, classes): top_4 here
        assert 0.0 <= out[f"{tag}_top_1"] <= out[f"{tag}_top_4"] <= 1.0
        assert out[f"{tag}_finite"]


def test_probe_cli_prints_one_json_line(jax_checkpoint, monkeypatch, capsys):
    monkeypatch.setenv("DEDLOC_FORCE_CPU", "1")
    ckpt = jax_checkpoint[0]
    swav_probe.main(["probe", "--checkpoint_dir", ckpt, "--classes", "4",
                     "--probe_per_class", "5", "--probe_size", "32",
                     "--batch_size", "8", "--model_size", "tiny"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["checkpoint_step"] == 7 and "trained_trunk_top_1" in out
    assert "random_trunk_top_1" in out and "features" not in out


def test_generate_writes_the_class_folders(tmp_path):
    swav_probe.generate(argparse.Namespace(out=str(tmp_path), classes=4,
                                           per_class=2, size=32, seed=0))
    assert sorted(os.listdir(tmp_path)) == [f"class_{k:02d}" for k in range(4)]
    assert all(len(os.listdir(tmp_path / d)) == 2 for d in os.listdir(tmp_path))
