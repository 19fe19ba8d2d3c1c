"""The port's Kimi Linear causal LM (``models/kimi_linear.py``) against its
plain reference (``testing/plain_kimi_linear.py``, KDA as the token
recurrence) on the CPU in float32: logits, loss and every leaf's gradient
for several shares of the experts on the tiny twin (a KDA layer with the
dense FFN, a KDA layer and a NoPE latent-attention layer with experts), the
shares at k = 8 with one shared expert summing to the uncut layer, one step
through the flat LAMB apply with the bias update, the family's name check
and the trainer role on the tiny twin."""
import json

import numpy as np
import pytest
import torch

from dedloc_tpu_torch.averaging.device_flat import DeviceFlatPipeline
from dedloc_tpu_torch.collaborative.optimizer import _fused_mean_clip
from dedloc_tpu_torch.core.config import CollaborationArguments, parse_config
from dedloc_tpu_torch.data.packed import packed_lm_batches
from dedloc_tpu_torch.models.kimi_linear import KimiLinearConfig, short_conv
from dedloc_tpu_torch.optim.lamb import Lamb
from dedloc_tpu_torch.parallel import moe
from dedloc_tpu_torch.parallel.train_step import (
    TrainState, make_accumulate_step, make_flat_apply_step, zeros_like_grads)
from dedloc_tpu_torch.roles.common import (
    build_flat_opt_factory, build_loss_fn, build_model, check_model_size)
from dedloc_tpu_torch.testing import plain_deepseek_v3 as plain_ds
from dedloc_tpu_torch.testing import plain_kimi_linear as plain

# float32 on both sides; the port's KDA is the chunked form (its plain
# mirror), the reference the token loop: the gaps are rounding, ~1e-6 of
# each tensor's scale
TOL = dict(rtol=1e-4, atol=1e-5)
SHARES = [(0, 0), (8, 0), (4, 2)]  # (experts held, rank) of 16: all, half, a quarter


def _model(held=0, rank=0, seed=0):
    cfg, model = build_model("kimi-linear-tiny", device="cpu", seed=seed,
                             moe_experts_held=held, expert_rank=rank)
    g = torch.Generator().manual_seed(seed + 1)
    for layer in model.model.layers[cfg.first_k_dense_replace:]:
        # a bias that moves the selection, as a trained one does
        layer.mlp.gate.e_score_correction_bias.copy_(
            torch.randn(cfg.n_routed_experts, generator=g) * 0.05)
    return cfg, model


def _config_dict(cfg: KimiLinearConfig) -> dict:
    return {f.name: getattr(cfg, f.name) for f in cfg.__dataclass_fields__.values()}


def _biases(model, cfg):
    return {i: model.model.layers[i].mlp.gate.e_score_correction_bias.clone()
            for i in range(cfg.first_k_dense_replace, cfg.num_hidden_layers)}


def _batch(cfg, rows=2, seq=40, seed=3):
    b = next(packed_lm_batches(cfg.vocab_size, rows, seq, seed))
    return {k: torch.as_tensor(v) for k, v in b.items()}


def test_the_tiny_twin_has_every_layer_kind():
    cfg, model = _model()
    kinds = [(layer.kda, type(layer.mlp).__name__) for layer in model.model.layers]
    assert kinds == [(True, "SwiGLU"), (True, "MoE"), (False, "MoE")]
    assert cfg.mla_use_nope and cfg.num_experts_per_tok == 8 and cfg.n_shared_experts == 1


@pytest.mark.parametrize("held,rank", SHARES)
def test_model_matches_the_plain_reference(held, rank):
    cfg, model = _model(held, rank)
    params = dict(model.named_parameters())
    batch = _batch(cfg)
    loss, metrics = build_loss_fn(model)(params, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    c = _config_dict(cfg)
    P = {n: p.detach().clone().requires_grad_(True) for n, p in params.items()}
    assert sorted(P) == sorted(n for n, *_ in plain.spec(c))
    assert all(P[n].shape == shape for n, shape, *_ in plain.spec(c))
    ref_loss, ref_loads = plain.loss(P, _biases(model, cfg), batch, c)
    ref_grads = torch.autograd.grad(ref_loss, list(P.values()))
    torch.testing.assert_close(loss, ref_loss, **TOL)
    torch.testing.assert_close(metrics["expert_loads"], ref_loads)
    assert metrics["kda_state_norm"].shape == (2,)
    for name, g, r in zip(params, grads, ref_grads):
        torch.testing.assert_close(g, r, **TOL, msg=name)
    with torch.no_grad():
        got = model.logits(batch["input_ids"])
        want = plain.logits(P, _biases(model, cfg), batch["input_ids"], c)
    torch.testing.assert_close(got, want, **TOL)


def test_the_state_norm_is_the_largest_heads_final_state():
    cfg, model = _model()
    params = dict(model.named_parameters())
    batch = _batch(cfg, rows=1)
    with torch.no_grad():
        _loss, metrics = build_loss_fn(model)(params, batch)
    c = _config_dict(cfg)
    x = params["model.embed_tokens.weight"][batch["input_ids"][0].long()]
    h = plain_ds.rms_norm(x, params["model.layers.0.input_layernorm.weight"],
                          cfg.rms_norm_eps)
    q, k, v, g, beta = plain.mixer_inputs(params, "model.layers.0.", h, c)
    state = torch.zeros(cfg.kda_heads, cfg.kda_head_dim, cfg.kda_head_dim)
    for t in range(q.shape[0]):
        state = state * g[t].exp()[..., None]
        pred = torch.einsum("hkv,hk->hv", state, k[t])
        state = state + k[t][..., None] * (beta[t][:, None] * (v[t] - pred))[:, None, :]
    want = state.pow(2).sum((-1, -2)).sqrt().max()
    torch.testing.assert_close(metrics["kda_state_norm"][0], want, **TOL)


def test_the_short_convolution_is_the_causal_depthwise_conv1d():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 9, 6, generator=g)
    w = torch.randn(6, 4, generator=g)
    got = short_conv(x, w)
    want = torch.stack([plain.short_conv(row, w) for row in x])
    torch.testing.assert_close(got, want, **TOL)
    # causal: the first output sees the first input alone
    torch.testing.assert_close(got[:, 0], x[:, 0] * w[:, -1], **TOL)


def test_the_shares_at_k8_with_a_shared_expert_add_up_to_the_uncut_layer():
    g = torch.Generator().manual_seed(0)
    t, h, e, f, top_k = 24, 16, 16, 8, 8
    x = torch.randn(t, h, generator=g)
    router = torch.randn(e, h, generator=g) * 0.3
    gate_up = torch.randn(e, h, 2 * f, generator=g) * 0.2
    down = torch.randn(e, f, h, generator=g) * 0.2
    bias = torch.randn(e, generator=g) * 0.1
    shared = {"s.gate_proj.weight": torch.randn(f, h, generator=g) * 0.2,
              "s.up_proj.weight": torch.randn(f, h, generator=g) * 0.2,
              "s.down_proj.weight": torch.randn(h, f, generator=g) * 0.2}
    c = {"n_routed_experts": e, "num_experts_per_tok": top_k,
         "routed_scaling_factor": 2.446, "moe_intermediate_size": f,
         "n_shared_experts": 1}
    r = moe.route_topk(router, bias, x, top_k, 2.446)
    n = 2  # eight ranks of two experts each
    total = sum(moe.routed_experts(x, r, gate_up[i:i + n], down[i:i + n], i, torch.float32)
                for i in range(0, e, n))
    total = total + plain_ds._swiglu(shared, "s", x)  # the shared expert, once
    P = {"L.mlp.gate.weight": router, "L.mlp.experts.gate_up_proj": gate_up,
         "L.mlp.experts.down_proj": down,
         **{k.replace("s.", "L.mlp.shared_experts."): v for k, v in shared.items()}}
    uncut, _bal, loads = plain_ds._moe(P, "L.", x, bias, c)
    torch.testing.assert_close(total, uncut, **TOL)
    assert float(loads.sum()) == t * top_k


def test_one_step_through_the_flat_lamb_apply_moves_the_bias():
    cfg, model = _model(held=8, rank=1)
    params = dict(model.named_parameters())
    args = parse_config(CollaborationArguments, [
        "--dht.experiment_prefix", "x", "--training.warmup_steps", "0",
        "--training.learning_rate", "0.01", "--training.weight_decay", "0.1"])
    tx_args = args.training
    batches = [_batch(cfg, seed=s) for s in (3, 4)]
    acc, n = zeros_like_grads(params), 0
    step = make_accumulate_step(build_loss_fn(model))
    loads = torch.zeros(cfg.moe_layers, cfg.n_routed_experts)
    for b in batches:
        acc, n, metrics = step(params, acc, n, b)
        loads += metrics["expert_loads"]
    biases0 = _biases(model, cfg)
    P0 = {k: v.detach().clone() for k, v in params.items()}
    spec = DeviceFlatPipeline.for_tree(acc).spec
    flat = make_flat_apply_step(build_flat_opt_factory(tx_args)(spec, params), spec,
                                post_apply=lambda s: (model.bias_update(loads), s)[1],
                                from_tree=True)
    tx = Lamb(learning_rate=lambda c: 0.01, weight_decay=0.1,
              max_grad_norm=tx_args.max_grad_norm, clamp_value=tx_args.clamp_value)
    state = TrainState.create(params, tx)
    state, ok = flat(state, _fused_mean_clip(acc, n, 0.0))
    assert bool(ok)
    P = {k: v.clone().requires_grad_(True) for k, v in P0.items()}
    c = _config_dict(cfg)
    ref_acc = {k: torch.zeros_like(v) for k, v in P.items()}
    ref_loads = 0
    for b in batches:
        loss, l_ = plain.loss(P, biases0, b, c)
        for k, g in zip(P, torch.autograd.grad(loss, list(P.values()))):
            ref_acc[k] += g
        ref_loads = ref_loads + l_
    mean = {k: g / 2 for k, g in ref_acc.items()}
    upd, _ = tx.update(mean, tx.init(P0), P0)
    for k in P0:
        torch.testing.assert_close(params[k].detach(), P0[k] + upd[k], rtol=1e-4,
                                   atol=1e-6, msg=k)
    plain.bias_update(biases0, ref_loads, cfg.bias_update_speed)
    torch.testing.assert_close(model.correction_biases(),
                               torch.stack(list(biases0.values())))


@pytest.mark.parametrize("size", ["moonlight-16b-a3", "kimi-linear-48b", "base"])
def test_an_unknown_size_names_every_family(size):
    with pytest.raises(ValueError) as err:
        check_model_size(size)
    for known in ("tiny", "large", "moonlight-16b-a3b", "deepseek-v3-tiny",
                  "kimi-linear-48b-a3b", "kimi-linear-tiny"):
        assert known in str(err.value)
    with pytest.raises(ValueError, match="kimi-linear-48b-a3b"):
        build_model(size, device="meta")


def test_the_published_config_is_kept():
    cfg = KimiLinearConfig.named("kimi-linear-48b-a3b")
    assert (cfg.hidden_size, cfg.kda_heads, cfg.kda_head_dim, cfg.short_conv_kernel_size) \
        == (2304, 32, 128, 4)
    assert (cfg.num_attention_heads, cfg.qk_head_dim, cfg.v_head_dim, cfg.kv_lora_rank) \
        == (32, 192, 128, 512)
    assert (cfg.n_routed_experts, cfg.num_experts_per_tok, cfg.n_shared_experts,
            cfg.moe_intermediate_size, cfg.intermediate_size) == (256, 8, 1, 1024, 9216)
    assert [i + 1 for i in range(27) if not cfg.is_kda(i)] == [4, 8, 12, 16, 20, 24, 27]


def test_the_trainer_role_runs_two_steps_on_the_tiny_twin(tmp_path, monkeypatch):
    from dedloc_tpu_torch.roles import trainer
    from dedloc_tpu_torch.telemetry.registry import Telemetry

    monkeypatch.setenv("DEDLOC_FORCE_CPU", "1")
    tele = Telemetry()
    monkeypatch.setattr(trainer, "configure_role_telemetry",
                        lambda args, key: (tele, lambda: None))
    args = parse_config(CollaborationArguments, [
        "--dht.experiment_prefix", "torch-kimi", "--dht.listen_host", "127.0.0.1",
        "--training.model_size", "kimi-linear-tiny",
        "--training.mesh_expert_devices", "2", "--training.mesh_device_offset", "1",
        "--training.per_device_batch_size", "2", "--training.seq_length", "40",
        "--training.gradient_accumulation_steps", "2", "--training.warmup_steps", "0",
        "--training.max_local_steps", "2", "--training.save_steps", "0",
        "--training.output_dir", str(tmp_path / "out"),
        "--training.train_log_path", str(tmp_path / "train.jsonl"),
        "--optimizer.target_batch_size", "4",
        "--averager.metadata_expiration", "0.2", "--averager.min_refresh_period", "0.1",
        "--averager.default_refresh_period", "0.2", "--checkpoint.cache_dir", "none"])
    state = trainer.run_trainer(args)
    gate_up = next(p for n, p in state.params.items() if "experts.gate_up_proj" in n)
    assert gate_up.shape[0] == 8  # rank 1 holds experts 8-15 of 16
    # the largest KDA final-state norm, read with the loss at the boundary
    assert tele.gauges["kda.state_norm_max"].value > 0
    assert any(n.endswith("self_attn.A_log") for n in state.params)
    records = [json.loads(line) for line in
               (tmp_path / "train.jsonl").read_text().splitlines()]
    assert records and all(np.isfinite(r["loss"]) for r in records)
    assert all(torch.isfinite(v).all() for v in state.params.values())
