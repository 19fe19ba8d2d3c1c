"""The port's Switch-MoE ALBERT against the JAX package's, with the same
weights (carried by ``models/convert.py``) and the same numpy batch: MLM and
SOP logits, the loss with the aux term, and every leaf's gradient in fp32,
under remat "" (the builders' defaults) and "fused_ln" (with flash
attention; the JAX side runs its Pallas kernels in interpret mode); and
remat changing no gradient. bf16, the schema fingerprint, checkpoints and
the trainer role are in ``tests/test_torch_moe_peer.py``."""
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

MOE = dict(moe_experts=4, moe_capacity_factor=1.25, moe_aux_weight=0.01)
# remat "" is the builders' default (remat on, policy "nothing", dense
# attention, no fused add+LN); "fused_ln" the recipe's, with flash attention
POLICIES = {"": dict(), "fused_ln": dict(remat_policy="fused_ln", fused_ln=True,
                                         attention_impl="flash")}
# the tolerances of tests/test_torch_albert.py's dense model
FP32 = dict(loss=1e-5, logits=dict(atol=1e-5, rtol=1e-5),
            grads=dict(atol=5e-4, rtol=5e-3))
BF16 = dict(loss=2e-2, logits=dict(atol=5e-2, rtol=5e-2))
MOE_LEAVES = ("moe_router", "moe_wi", "moe_wo")


def _batch():
    cfg = AlbertConfig.tiny()
    batch = next(synthetic_mlm_batches(cfg, batch_size=2, seq_length=64, seed=0))
    batch["attention_mask"][1, 40:] = 0  # one padded sample
    batch["token_type_ids"][:, 32:] = 1
    return batch


def _jax_named(tree):
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_init(batch):
    """The JAX MoE model's parameter tree (its shapes from ``eval_shape``)
    with values drawn by numpy: normal(0.02) kernels, embeddings and MoE
    leaves, LayerNorm scales near one, small biases."""
    shapes = jax.eval_shape(lambda: JaxModel(JaxConfig.tiny(**MOE)).init(
        jax.random.PRNGKey(0), jnp.asarray(batch["input_ids"]))["params"])
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return jnp.asarray(1.0 + rng.normal(0, 0.1, leaf.shape), jnp.float32)
        scale = 0.01 if name.endswith("bias']") else 0.02
        return jnp.asarray(rng.normal(0, scale, leaf.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_run(params, batch, dtype, policy, with_grads, **jit_kw):
    model = JaxModel(JaxConfig.tiny(dtype=dtype, **MOE, **POLICIES[policy]))
    jb = {k: jnp.asarray(batch[k]) for k in drop_collator_keys(batch, "cpu")}
    loss_fn = jax_build_loss_fn(model)

    def loss_and_logits(params):
        loss, metrics = loss_fn(params, jb, jax.random.PRNGKey(1))
        (mlm, sop), _ = model.apply(
            {"params": params}, jb["input_ids"], jb["attention_mask"],
            jb["token_type_ids"], mlm_positions=jb["mlm_positions"],
            mutable=("losses",))
        return loss, (mlm, sop, metrics["moe_aux"])

    if with_grads:
        (loss, (mlm, sop, aux)), grads = jax.jit(
            jax.value_and_grad(loss_and_logits, has_aux=True), **jit_kw)(params)
        grads = _jax_named(grads)
    else:
        loss, (mlm, sop, aux) = jax.jit(loss_and_logits, **jit_kw)(params)
        grads = None
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    return dict(mlm=f32(mlm), sop=f32(sop), loss=float(loss), aux=float(aux),
                grads=grads)


def _port_model(named, dtype, policy):
    model = AlbertForPreTraining(AlbertConfig.tiny(dtype=dtype, **MOE,
                                                   **POLICIES[policy]))
    model.load_state_dict(convert.params_from_jax(named))
    return model


def _port_run(named, batch, dtype, policy):
    model = _port_model(named, dtype, policy)
    tb = drop_collator_keys(batch, device="cpu")
    params = dict(model.named_parameters())
    losses = {}
    mlm, sop = model(tb["input_ids"], tb["attention_mask"], tb["token_type_ids"],
                     mlm_positions=tb["mlm_positions"], losses=losses)
    loss, metrics = build_loss_fn(model)(params, tb)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert torch.equal(losses["moe_aux"], metrics["moe_aux"])
    return dict(mlm=mlm.detach().float().numpy(),
                sop=sop.detach().float().numpy(), loss=float(loss.detach()),
                aux=float(metrics["moe_aux"].detach()),
                grads=convert.params_to_jax(dict(zip(params, grads))))


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.fixture(scope="module")
def jparams(batch):
    return _jax_init(batch)


@pytest.fixture(scope="module")
def named(jparams):
    return _jax_named(jparams)


@pytest.fixture(scope="module", params=sorted(POLICIES))
def fp32_case(request, batch, jparams, named):
    ref = _jax_run(jparams, batch, jnp.float32, request.param, with_grads=True)
    return ref, _port_run(named, batch, torch.float32, request.param)


def test_moe_leaves_replace_the_dense_ffn(named):
    block = "['albert']['encoder']['layer']['block']"
    assert not any("['ffn']" in n or "['ffn_output']" in n for n in named)
    shapes = {leaf: named[f"{block}['{leaf}']"].shape for leaf in MOE_LEAVES}
    assert shapes == {"moe_router": (32, 4), "moe_wi": (4, 32, 64),
                      "moe_wo": (4, 64, 32)}
    model = AlbertForPreTraining(AlbertConfig.tiny(**MOE))
    assert sorted(convert.params_to_jax(dict(model.named_parameters()))) == sorted(named)
    # the layouts agree: the converter's permutation is the identity
    for leaf in MOE_LEAVES:
        assert convert.jax_keys(f"albert.encoder.layer.block.{leaf}", 3)[1] is None


def test_fp32_logits_match(fp32_case):
    ref, port = fp32_case
    np.testing.assert_allclose(port["mlm"], ref["mlm"], **FP32["logits"])
    np.testing.assert_allclose(port["sop"], ref["sop"], **FP32["logits"])


def test_fp32_loss_with_aux_matches(fp32_case):
    ref, port = fp32_case
    assert abs(port["loss"] - ref["loss"]) <= FP32["loss"]
    assert port["aux"] == pytest.approx(ref["aux"], rel=1e-5)
    # the aux term is in the loss: 2 applications of about 1 each at 0.01
    assert 0.015 < 0.01 * port["aux"] < 0.1


@pytest.mark.parametrize("leaf", range(31))
def test_fp32_gradient_of_every_leaf_matches(fp32_case, leaf):
    ref, port = fp32_case
    assert len(ref["grads"]) == 31
    name = sorted(ref["grads"])[leaf]
    np.testing.assert_allclose(port["grads"][name], ref["grads"][name],
                               **FP32["grads"], err_msg=name)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_remat_changes_no_gradient_bitwise(batch, named, policy):
    """Each policy against the same config without remat: the MoE branch is
    recomputed in the backward, and the recompute routes identically."""
    remat = _port_run(named, batch, torch.float32, policy)
    POLICIES["no_remat"] = dict(POLICIES[policy], remat=False)
    try:
        plain = _port_run(named, batch, torch.float32, "no_remat")
    finally:
        del POLICIES["no_remat"]
    for name, g in plain["grads"].items():
        assert remat["grads"][name].tobytes() == g.tobytes(), name
