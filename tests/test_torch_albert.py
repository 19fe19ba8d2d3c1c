"""The port's ALBERT against the JAX package's, with the same weights carried
across by ``models/convert.py`` and the same numpy batch: MLM and SOP logits,
the MLM+SOP loss and the gradient of every named parameter, on the tiny
config with flash attention and the fused add+LayerNorm (the JAX side runs
its Pallas kernels in interpret mode, the port its plain versions)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.models.albert import AlbertConfig as JaxConfig
from dedloc_tpu.models.albert import AlbertForPreTraining as JaxModel
from dedloc_tpu.roles.common import build_loss_fn as jax_build_loss_fn
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.models.albert import AlbertConfig, AlbertForPreTraining
from dedloc_tpu_torch.roles.common import (
    build_loss_fn,
    drop_collator_keys,
    synthetic_mlm_batches,
)

RECIPE = dict(attention_impl="flash", remat_policy="fused_ln", fused_ln=True)
# fp32: loss 1e-5; grads as tests/test_fused_ln.py (5e-4 abs / 5e-3 rel).
# bf16: both frameworks round every matmul output and activation to bf16 at
# slightly different places (XLA rounds after each elementwise op, PyTorch
# once per fused op), so logits agree to a few bf16 steps (2^-8 relative)
# and the loss to 2e-2.
FP32 = dict(loss=1e-5, logits=dict(atol=1e-5, rtol=1e-5),
            grads=dict(atol=5e-4, rtol=5e-3))
BF16 = dict(loss=2e-2, logits=dict(atol=5e-2, rtol=5e-2))


def _batch():
    cfg = AlbertConfig.tiny()
    batch = next(synthetic_mlm_batches(cfg, batch_size=2, seq_length=64, seed=0))
    batch["attention_mask"][1, 40:] = 0  # one padded sample
    batch["token_type_ids"][:, 32:] = 1
    return batch


def _jax_named(params):
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in flat}


def _jax_reference(dtype, batch, with_grads):
    # the parameter tree does not depend on the kernels: initialise through
    # the plain dense path (cheap), then run the recipe with the kernels
    ids = jnp.asarray(batch["input_ids"])
    params = JaxModel(JaxConfig.tiny(dtype=dtype)).init(
        jax.random.PRNGKey(0), ids)["params"]
    model = JaxModel(JaxConfig.tiny(dtype=dtype, **RECIPE))
    jb = {k: jnp.asarray(batch[k]) for k in drop_collator_keys(batch, "cpu")}
    loss_fn = jax_build_loss_fn(model)

    def loss_and_logits(params):
        loss, _ = loss_fn(params, jb, jax.random.PRNGKey(1))
        mlm, sop = model.apply({"params": params}, jb["input_ids"],
                               jb["attention_mask"], jb["token_type_ids"],
                               mlm_positions=jb["mlm_positions"])
        return loss, (mlm, sop)

    if with_grads:
        (loss, (mlm, sop)), grads = jax.jit(
            jax.value_and_grad(loss_and_logits, has_aux=True))(params)
        grads = _jax_named(grads)
    else:
        loss, (mlm, sop) = jax.jit(loss_and_logits)(params)
        grads = None
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    return dict(named=_jax_named(params), mlm=f32(mlm), sop=f32(sop),
                loss=float(loss), grads=grads)


def _port(dtype, named, batch):
    model = AlbertForPreTraining(AlbertConfig.tiny(dtype=dtype, **RECIPE))
    model.load_state_dict(convert.params_from_jax(named))
    tb = drop_collator_keys(batch, device="cpu")
    params = dict(model.named_parameters())
    mlm, sop = model(tb["input_ids"], tb["attention_mask"], tb["token_type_ids"],
                     mlm_positions=tb["mlm_positions"])
    loss, _ = build_loss_fn(model)(params, tb)
    grads = torch.autograd.grad(loss, list(params.values()))
    return dict(mlm=mlm.detach().numpy(), sop=sop.detach().numpy(),
                loss=float(loss.detach()),
                grads=convert.params_to_jax(dict(zip(params, grads))))


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.fixture(scope="module")
def fp32_case(batch):
    ref = _jax_reference(jnp.float32, batch, with_grads=True)
    return ref, _port(torch.float32, ref["named"], batch)


def test_tiny_config_has_32_named_leaves(fp32_case):
    ref, port = fp32_case
    assert len(ref["named"]) == 32
    assert sorted(port["grads"]) == sorted(ref["named"])


def test_fp32_logits_match(fp32_case):
    ref, port = fp32_case
    assert port["mlm"].shape == ref["mlm"].shape == (2, 13, 512)
    np.testing.assert_allclose(port["mlm"], ref["mlm"], **FP32["logits"])
    np.testing.assert_allclose(port["sop"], ref["sop"], **FP32["logits"])


def test_fp32_loss_matches(fp32_case):
    ref, port = fp32_case
    assert abs(port["loss"] - ref["loss"]) <= FP32["loss"]


@pytest.mark.parametrize("leaf", range(32))
def test_fp32_gradient_of_every_leaf_matches(fp32_case, leaf):
    ref, port = fp32_case
    name = sorted(ref["grads"])[leaf]
    np.testing.assert_allclose(port["grads"][name], ref["grads"][name],
                               **FP32["grads"], err_msg=name)


def test_bf16_logits_and_loss_match(batch):
    ref = _jax_reference(jnp.bfloat16, batch, with_grads=False)
    port = _port(torch.bfloat16, ref["named"], batch)
    np.testing.assert_allclose(port["mlm"], ref["mlm"], **BF16["logits"])
    np.testing.assert_allclose(port["sop"], ref["sop"], **BF16["logits"])
    assert abs(port["loss"] - ref["loss"]) <= BF16["loss"]
    # at init the loss sits near ln(vocab) + ln(2)
    assert abs(port["loss"] - (np.log(512) + np.log(2))) < 0.5


def test_convert_round_trip_is_exact(fp32_case):
    named = fp32_case[0]["named"]
    back = convert.params_to_jax(convert.params_from_jax(named))
    assert sorted(back) == sorted(named)
    for name, arr in named.items():
        assert back[name].dtype == arr.dtype and back[name].shape == arr.shape
        np.testing.assert_array_equal(back[name], arr, err_msg=name)


def test_convert_accepts_slash_joined_names(fp32_case):
    named = fp32_case[0]["named"]
    slashed = {"/".join(convert.jax_path(n)): a for n, a in named.items()}
    state = convert.params_from_jax(slashed)
    ref = convert.params_from_jax(named)
    assert sorted(state) == sorted(ref)
    # a Dense kernel [in, out] becomes a Linear weight [out, in]
    q = "albert.encoder.layer.block.attention.query.weight"
    kernel = named["['albert']['encoder']['layer']['block']['attention']['query']['kernel']"]
    np.testing.assert_array_equal(state[q].numpy(), kernel.T)


def test_unported_features_raise():
    for overrides in (dict(attention_impl="ring"),
                      dict(moe_experts=2, moe_mesh=object()),
                      dict(pipe_mesh=object())):
        with pytest.raises(NotImplementedError):
            AlbertForPreTraining(AlbertConfig.tiny(**overrides))


def test_flash_rejects_attention_dropout_in_training_only(batch):
    model = AlbertForPreTraining(AlbertConfig.tiny(
        attention_impl="flash", attention_dropout_prob=0.1, dtype=torch.float32))
    ids = torch.as_tensor(batch["input_ids"])
    model(ids, deterministic=True)  # eval: dropout inactive, must work
    with pytest.raises(ValueError, match="attention dropout"):
        model(ids, deterministic=False)
