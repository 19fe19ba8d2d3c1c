"""Rematerialisation in the port (``models/albert.py`` ``remat_policy_object``
and the checkpointed encoder): every policy of the JAX package gives the
gradients of the model without remat, the policies that save the kernels'
outputs run each kernel forward once per block application (the others
twice: forward and recompute), and an unknown name raises as in JAX. On the
CPU the kernel operators take their plain versions, so the test counts the
calls to those."""
import numpy as np
import pytest
import torch

from dedloc_tpu.models.albert import remat_policy_object as jax_remat_policy_object
from dedloc_tpu_torch.models.albert import (
    AlbertConfig,
    AlbertForPreTraining,
    fused_ln_for_policy,
    init_weights,
    remat_policy_object,
)
from dedloc_tpu_torch.ops import flash_attention as fa
from dedloc_tpu_torch.ops import fused_ln as fl
from dedloc_tpu_torch.roles.common import (
    build_loss_fn,
    drop_collator_keys,
    synthetic_mlm_batches,
)

POLICIES = ("nothing", "dots", "dots_no_batch", "dots_no_batch_attn",
            "fused_ln", "fused_ln_gelu")
# the policies that save the flash forward's outputs (out, lse)
SAVE_FLASH = {"dots_no_batch_attn", "fused_ln", "fused_ln_gelu"}
# the same arithmetic replayed on the CPU: 1e-6 (bitwise in practice)
TOL = dict(atol=1e-6, rtol=0.0)
LAYERS = 2  # block applications of the tiny config


def _grads(policy, impl, remat, fused_ln=None, calls=None, monkeypatch=None):
    fused_ln = fused_ln_for_policy(policy) if fused_ln is None else fused_ln
    cfg = AlbertConfig.tiny(remat=remat, remat_policy=policy, fused_ln=fused_ln,
                            attention_impl=impl, attention_block_size=16,
                            num_hidden_layers=LAYERS)
    model = AlbertForPreTraining(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    batch = next(synthetic_mlm_batches(cfg, 2, 64, seed=0))
    batch["attention_mask"][1, 40:] = 0
    batch = drop_collator_keys(batch, device="cpu")
    params = dict(model.named_parameters())
    if calls is not None:  # count the forward kernels' plain versions
        for mod, name in ((fa, "flash_fwd_plain"), (fl, "ln_fwd_plain")):
            plain = getattr(mod, name)

            def counted(*args, _plain=plain, _name=name, **kwargs):
                calls[_name] += 1
                return _plain(*args, **kwargs)

            monkeypatch.setattr(mod, name, counted)
    loss, _ = build_loss_fn(model)(params, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return {n: g.float().numpy() for n, g in zip(params, grads)}


@pytest.mark.parametrize("impl", ("flash", "dense", "blockwise"))
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_gives_the_gradients_without_remat(policy, impl):
    want = _grads(policy, impl, remat=False)
    got = _grads(policy, impl, remat=True)
    assert sorted(got) == sorted(want) and len(got) == 32
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **TOL, err_msg=name)


@pytest.mark.parametrize("policy", POLICIES)
def test_flash_forward_runs_once_where_the_policy_saves_it(policy, monkeypatch):
    calls = {"flash_fwd_plain": 0, "ln_fwd_plain": 0}
    _grads(policy, "flash", remat=True, calls=calls, monkeypatch=monkeypatch)
    per_application = 1 if policy in SAVE_FLASH else 2
    assert calls["flash_fwd_plain"] == per_application * LAYERS


@pytest.mark.parametrize("policy,per_application",
                         [("fused_ln", 2), ("fused_ln_gelu", 2), ("nothing", 4)])
def test_add_ln_forward_runs_once_where_the_policy_saves_it(
        policy, per_application, monkeypatch):
    """Two add+LN per block: once each under fused_ln*, and again in the
    recompute under nothing (both with the fused kernel on)."""
    calls = {"flash_fwd_plain": 0, "ln_fwd_plain": 0}
    _grads(policy, "flash", remat=True, fused_ln=True, calls=calls,
           monkeypatch=monkeypatch)
    assert calls["ln_fwd_plain"] == per_application * LAYERS


def test_without_remat_each_forward_runs_once(monkeypatch):
    calls = {"flash_fwd_plain": 0, "ln_fwd_plain": 0}
    _grads("nothing", "flash", remat=False, fused_ln=True, calls=calls,
           monkeypatch=monkeypatch)
    assert calls == {"flash_fwd_plain": LAYERS, "ln_fwd_plain": 2 * LAYERS}


def test_unknown_policy_raises_as_in_jax():
    with pytest.raises(ValueError) as theirs:
        jax_remat_policy_object("dots_no_batch_attnn")
    with pytest.raises(ValueError) as ours:
        remat_policy_object("dots_no_batch_attnn")
    # the same message, so the same table of names
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="unknown remat_policy"):
        AlbertForPreTraining(AlbertConfig.tiny(remat_policy="dots_no_batch_attnn"))
    # without remat the name only picks the add+LN path, as in JAX
    AlbertForPreTraining(AlbertConfig.tiny(remat=False, remat_policy="bogus"))
