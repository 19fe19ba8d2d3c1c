"""``dedloc_tpu_torch/tools/profile_albert.py`` on the CPU: its stages run
the plain versions at a tiny size and emit one JSON row each, with a CPU
time (never a device metric); the ``model`` stage's loss equals the JAX
package's on the same weights and batch; on the CPU the tool's kernels
count no launch."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.models.albert import AlbertConfig as JaxConfig
from dedloc_tpu.models.albert import AlbertForPreTraining as JaxModel
from dedloc_tpu.roles.common import build_loss_fn as jax_build_loss_fn
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.ops import flash_attention as fa
from dedloc_tpu_torch.ops import fused_ln as fl
from dedloc_tpu_torch.roles.common import build_model, synthetic_mlm_batches
from dedloc_tpu_torch.tools import profile_albert as pa

# bf16 on both sides (the tiny config's dtype): as tests/test_torch_albert.py
LOSS_ATOL = 2e-2
KEYS = ("input_ids", "attention_mask", "token_type_ids", "mlm_positions",
        "mlm_label_ids", "mlm_weights", "sop_labels")


@pytest.fixture(scope="module")
def rows():
    for w in fa.WRAPPERS + fl.WRAPPERS:
        w.launches = 0
    out = []
    prof = pa.Profiler(torch.device("cpu"), emit=out.append)
    assert pa.run_peak(prof) is None
    pa.run_pieces(prof)
    pa.run_model(prof)
    return out


def test_every_row_is_json_with_a_cpu_time(rows):
    timed = [r for r in rows if "cpu_ms" in r]
    assert len(timed) == len(rows) - 2  # the model's loss and its samples/s
    for r in rows:
        json.dumps(r)
        assert "device_ms" not in r and "tflops_per_sec" not in r
    for r in timed:
        assert r["cpu_ms"] > 0


def test_the_stages_emit_the_reference_rows(rows):
    labels = [r["label"] for r in rows]
    for prefix in ("matmul_", "proj_", "ffn_pair_", "mlm_vocab_pair_",
                   "attn_dense_fwd ", "attn_dense_fwd+bwd", "attn_flash_fwd ",
                   "attn_flash_fwd+bwd", "add_ln_fwd ", "add_ln_fwd+bwd",
                   "model_fwd_only", "lamb_apply_only", "full_train_step"):
        assert any(l.startswith(prefix) for l in labels), prefix
    policies = {l.split(" ")[0] for l in labels if l.startswith("fwdbwd_")}
    assert policies == {"fwdbwd_fused_ln_flash", "fwdbwd_dots_no_batch_attn_flash",
                        "fwdbwd_dots_no_batch_flash", "fwdbwd_nothing_flash",
                        "fwdbwd_dots_flash", "fwdbwd_dots_no_batch_dense",
                        "fwdbwd_nothing_dense"}
    step = [r for r in rows if r["label"] == "full_step_cpu_samples_per_sec"]
    assert step and step[0]["value"] > 0 and 0 < step[0]["lamb_share_of_step"] < 1


def test_cpu_pieces_launch_no_kernel(rows):
    assert all(w.launches == 0 for w in fa.WRAPPERS + fl.WRAPPERS)


def test_model_loss_matches_jax_on_the_same_weights(rows):
    got = [r for r in rows if r["label"].startswith("model_loss")][0]
    cfg, model = build_model("tiny", "fused_ln", "flash", device="cpu", seed=0)
    named = convert.params_to_jax(dict(model.named_parameters()))
    batch = next(synthetic_mlm_batches(cfg, 2, 32, 0))
    jmodel = JaxModel(JaxConfig.tiny(attention_impl="flash", remat_policy="fused_ln",
                                     fused_ln=True))
    like = jax.eval_shape(lambda: JaxModel(JaxConfig.tiny()).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32), jnp.int32))["params"])
    from dedloc_tpu.collaborative.optimizer import _named_to_tree

    params = _named_to_tree({k: jnp.asarray(v) for k, v in named.items()}, like)
    loss, metrics = jax.jit(jax_build_loss_fn(jmodel))(
        params, {k: jnp.asarray(batch[k]) for k in KEYS}, jax.random.PRNGKey(1))
    assert abs(got["loss"] - float(loss)) <= LOSS_ATOL
    assert abs(got["mlm_loss"] - float(metrics["mlm_loss"])) <= LOSS_ATOL


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pa.main(["peak"])
