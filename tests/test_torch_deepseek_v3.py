"""The port's DeepSeek-V3 causal LM (``models/deepseek_v3.py``) against its
plain reference (``testing/plain_deepseek_v3.py``) on the CPU in float32:
logits, loss and every leaf's gradient for several shares of the experts,
the shares summing to the uncut layer, the router's rules, the causal
two-width flash path against softmax attention, one step through the flat
LAMB apply with the bias update, and the trainer role on the tiny twin."""
import json

import numpy as np
import pytest
import torch

from dedloc_tpu_torch.collaborative.optimizer import _fused_mean_clip
from dedloc_tpu_torch.core.config import CollaborationArguments, parse_config
from dedloc_tpu_torch.data.packed import EOS_ID, packed_lm_batches
from dedloc_tpu_torch.models.deepseek_v3 import DeepseekV3Config
from dedloc_tpu_torch.ops import flash_attention as fa
from dedloc_tpu_torch.optim.lamb import Lamb
from dedloc_tpu_torch.parallel import moe
from dedloc_tpu_torch.parallel.train_step import (
    TrainState, make_accumulate_step, make_flat_apply_step, zeros_like_grads)
from dedloc_tpu_torch.averaging.device_flat import DeviceFlatPipeline
from dedloc_tpu_torch.roles.common import build_flat_opt_factory, build_loss_fn, build_model
from dedloc_tpu_torch.testing import plain_deepseek_v3 as plain

# float32 on both sides, the same operations in other orders (the flash
# path's blocks, the grouped products, the per-expert loop): the gaps are
# rounding, ~1e-6 of each tensor's scale
TOL = dict(rtol=1e-4, atol=1e-5)
SHARES = [(0, 0), (4, 0), (2, 1)]  # (experts held, rank): all, the first half, a middle share


def _model(held=0, rank=0, seed=0, **over):
    over.setdefault("num_hidden_layers", 3)
    cfg, model = build_model("deepseek-v3-tiny", device="cpu", seed=seed,
                             moe_experts_held=held, expert_rank=rank, overrides=over)
    g = torch.Generator().manual_seed(seed + 1)
    for layer in model.model.layers[cfg.first_k_dense_replace:]:
        # a bias that moves the selection, as a trained one does
        layer.mlp.gate.e_score_correction_bias.copy_(
            torch.randn(cfg.n_routed_experts, generator=g) * 0.05)
    return cfg, model


def _config_dict(cfg: DeepseekV3Config) -> dict:
    return {f.name: getattr(cfg, f.name) for f in cfg.__dataclass_fields__.values()}


def _biases(model, cfg):
    return {i: model.model.layers[i].mlp.gate.e_score_correction_bias.clone()
            for i in range(cfg.first_k_dense_replace, cfg.num_hidden_layers)}


def _batch(cfg, rows=2, seq=32, seed=3):
    b = next(packed_lm_batches(cfg.vocab_size, rows, seq, seed))
    return {k: torch.as_tensor(v) for k, v in b.items()}


@pytest.mark.parametrize("held,rank", SHARES)
def test_model_matches_the_plain_reference(held, rank):
    cfg, model = _model(held, rank)
    params = dict(model.named_parameters())
    batch = _batch(cfg)
    loss, metrics = build_loss_fn(model)(params, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    P = {n: p.detach().clone().requires_grad_(True) for n, p in params.items()}
    assert sorted(P) == sorted(n for n, *_ in plain.spec(_config_dict(cfg)))
    ref_loss, ref_loads = plain.loss(P, _biases(model, cfg), batch, _config_dict(cfg))
    ref_grads = torch.autograd.grad(ref_loss, list(P.values()))
    torch.testing.assert_close(loss, ref_loss, **TOL)
    torch.testing.assert_close(metrics["expert_loads"], ref_loads)
    for name, g, r in zip(params, grads, ref_grads):
        torch.testing.assert_close(g, r, **TOL, msg=name)
    # the logits too, before the loss
    with torch.no_grad():
        got = model.logits(batch["input_ids"])
        want = plain.logits(P, _biases(model, cfg), batch["input_ids"], _config_dict(cfg))
    torch.testing.assert_close(got, want, **TOL)


def test_remat_gives_the_gradients_taken_without_it():
    cfg, model = _model()
    params = dict(model.named_parameters())
    batch = _batch(cfg)
    loss, _ = build_loss_fn(model)(params, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    # the same layers applied one by one, each outside any checkpoint
    from dedloc_tpu_torch.models import deepseek_v3 as ds

    orig = ds.checkpoint
    try:
        ds.checkpoint = lambda fn, *args, **kw: fn(*args)
        loss2, _ = build_loss_fn(model)(params, batch)
        grads2 = torch.autograd.grad(loss2, list(params.values()))
    finally:
        ds.checkpoint = orig
    torch.testing.assert_close(loss, loss2, **TOL)
    for a, b in zip(grads, grads2):
        torch.testing.assert_close(a, b, **TOL)


def _layer_inputs(seed=0, t=24, h=16, e=8, f=8):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(t, h, generator=g)
    router = torch.randn(e, h, generator=g) * 0.3
    gate_up = torch.randn(e, h, 2 * f, generator=g) * 0.2
    down = torch.randn(e, f, h, generator=g) * 0.2
    return x, router, gate_up, down


def test_the_shares_of_every_rank_add_up_to_the_uncut_layer():
    x, router, gate_up, down = _layer_inputs()
    e, top_k = router.shape[0], 3
    c = {"n_routed_experts": e, "num_experts_per_tok": top_k, "routed_scaling_factor": 2.446,
         "moe_intermediate_size": down.shape[1], "n_shared_experts": 1}
    bias = torch.randn(e, generator=torch.Generator().manual_seed(9)) * 0.1
    shared = {f"s.{n}.weight": torch.randn(w, x.shape[1] if n != "down_proj" else 8) * 0.2
              for n, w in (("gate_proj", 8), ("up_proj", 8))}
    shared["s.down_proj.weight"] = torch.randn(x.shape[1], 8) * 0.2
    r = moe.route_topk(router, bias, x, top_k, 2.446)
    total = sum(moe.routed_experts(x, r, gate_up[i:i + n], down[i:i + n], i, torch.float32)
                for n in (2,) for i in range(0, e, n))
    total = total + plain._swiglu(shared, "s", x)
    P = {"L.mlp.gate.weight": router, "L.mlp.experts.gate_up_proj": gate_up,
         "L.mlp.experts.down_proj": down,
         **{k.replace("s.", "L.mlp.shared_experts."): v for k, v in shared.items()}}
    uncut, _bal, _loads = plain._moe(P, "L.", x, bias, c)
    torch.testing.assert_close(total, uncut, **TOL)


def test_the_bias_moves_the_selection_but_not_the_gates():
    x, router, *_ = _layer_inputs()
    e = router.shape[0]
    plain_r = moe.route_topk(router, torch.zeros(e), x, 3, 2.446)
    bias = torch.zeros(e)
    bias[5] = 10.0  # every token now selects expert 5
    biased = moe.route_topk(router, bias, x, 3, 2.446)
    assert not torch.equal(plain_r.experts, biased.experts)
    assert bool((biased.experts == 5).any(-1).all())
    torch.testing.assert_close(biased.scores, plain_r.scores)
    picked = biased.scores.gather(-1, biased.experts)
    torch.testing.assert_close(biased.gates, picked / picked.sum(-1, keepdim=True) * 2.446)
    torch.testing.assert_close(biased.gates.sum(-1), torch.full((x.shape[0],), 2.446))


def test_every_token_to_one_expert_is_computed_and_none_dropped():
    x, router, gate_up, down = _layer_inputs()
    e = router.shape[0]
    bias = torch.zeros(e)
    bias[2] = 100.0
    r = moe.route_topk(router, bias, x, 2, 1.0)
    assert float(r.loads[2]) == x.shape[0] and float(r.loads.sum()) == 2 * x.shape[0]
    got = moe.routed_experts(x, r, gate_up[2:3], down[2:3], 2, torch.float32)
    f = down.shape[1]
    h = x @ gate_up[2]
    want = ((torch.nn.functional.silu(h[:, :f]) * h[:, f:]) @ down[2]) * (
        r.gates * (r.experts == 2))[:, :].sum(-1, keepdim=True)
    torch.testing.assert_close(got, want, **TOL)


class _MaskedGroupedMM(torch.autograd.Function):
    """The grouped product as the layer ran it before the row kernels: the
    rows past the last group zeroed after each product, forward and
    backward."""

    @staticmethod
    def forward(ctx, x, w, offs):
        ctx.save_for_backward(x, w, offs)
        real = (torch.arange(x.shape[0]) < offs[-1])[:, None]
        return torch.where(real, torch._grouped_mm(x, w, offs=offs), 0)

    @staticmethod
    def backward(ctx, dy):
        x, w, offs = ctx.saved_tensors
        real = (torch.arange(x.shape[0]) < offs[-1])[:, None]
        dx = torch.where(real, torch._grouped_mm(dy.contiguous(), w.transpose(-1, -2),
                                                 offs=offs), 0)
        return dx, torch._grouped_mm(x.t(), dy.contiguous(), offs=offs), None


def _masked_routed_experts(x, r, gate_up, down, first, dtype):
    """The expert layer's eager formula over all T * k sorted rows: an
    index_select gather, the masked grouped products, the SwiGLU in fp32,
    the inverse index_select and the gate-weighted bmm (gates rounded to
    ``dtype``)."""
    t, k = r.experts.shape
    n, f = down.shape[0], down.shape[1]
    local = r.experts - first
    held = (local >= 0) & (local < n)
    pairs = moe.sort_pairs(r.experts, first, n)
    rows = x.to(dtype).index_select(0, pairs.order // k)
    h = _MaskedGroupedMM.apply(rows, gate_up.to(dtype), pairs.offs)
    act = (torch.nn.functional.silu(h[:, :f].float()) * h[:, f:].float()).to(dtype)
    out = _MaskedGroupedMM.apply(act, down.to(dtype), pairs.offs)
    inverse = torch.empty_like(pairs.order).scatter_(0, pairs.order, torch.arange(t * k))
    per_pair = out.index_select(0, inverse).view(t, k, -1)
    weight = (r.gates * held).to(dtype)
    return torch.bmm(weight[:, None, :], per_pair)[:, 0].float()


# (routing, held block [first, first + n)) at k = 3 of 8 experts, T = 24:
# no pair held (live 0); every pair held, n >= k (live T * k) and n < k
# (live T * n: each token takes both held experts); a skewed routing (one
# held expert favoured, the others random)
ROUTINGS = {"none_held": (2, 2), "all_held": (0, 8), "all_held_few": (2, 2),
            "skewed": (2, 4)}


def _routing(name, seed=0):
    """(x, routing with leaf gates, gate_up, down, first, live) of a layer
    call whose held block is ``ROUTINGS[name]``."""
    x, router, gate_up, down = _layer_inputs(seed)
    e, t, k = router.shape[0], x.shape[0], 3
    first, n = ROUTINGS[name]
    bias = torch.randn(e, generator=torch.Generator().manual_seed(seed + 7)) * 0.1
    if name == "none_held":
        bias[first:first + n] = -100.0
    elif name == "all_held_few":
        bias[first:first + n] = 100.0
    elif name == "skewed":
        bias[first + 1] = 1.0
    r = moe.route_topk(router, bias, x, k, 2.446)
    r = r._replace(gates=r.gates.detach().requires_grad_(True))
    live = int(((r.experts >= first) & (r.experts < first + n)).sum())
    want = {"none_held": 0, "all_held": t * k, "all_held_few": t * min(k, n)}
    assert live == want.get(name, live) and (name != "skewed" or 0 < live < t * k)
    return (x.requires_grad_(True), r, gate_up[first:first + n].requires_grad_(True),
            down[first:first + n].requires_grad_(True), first, live)


@pytest.mark.parametrize("name", sorted(ROUTINGS))
def test_routed_experts_match_the_masked_formula(name):
    x, r, gate_up, down, first, _live = _routing(name)
    leaves = (x, r.gates, gate_up, down)
    got = moe.routed_experts(x, r, gate_up, down, first, torch.float32)
    want = _masked_routed_experts(x, r, gate_up, down, first, torch.float32)
    torch.testing.assert_close(got, want, **TOL)
    dy = torch.randn(got.shape, generator=torch.Generator().manual_seed(5))
    for leaf, a, b in zip(("x", "gates", "gate_up", "down"),
                          torch.autograd.grad(got, leaves, dy),
                          torch.autograd.grad(want, leaves, dy)):
        torch.testing.assert_close(a, b, **TOL, msg=leaf)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(ROUTINGS))
def test_the_row_passes_plain_versions_match_the_masked_formula(name, dtype):
    from dedloc_tpu_torch.ops import expert_rows as er

    x, r, _gate_up, _down, first, live = _routing(name)
    x, gates = x.detach(), r.gates.detach()
    (t, k), n = r.experts.shape, ROUTINGS[name][1]
    pairs = moe.sort_pairs(r.experts, first, n)
    assert int(pairs.offs[-1]) == live
    g = torch.Generator().manual_seed(11)
    # the gather: the live rows' tokens, and the inverse permutation
    rows, inverse = er.expert_gather_plain(x, pairs.order, pairs.offs, k, dtype)
    want_rows = x.to(dtype).index_select(0, pairs.order // k)
    torch.testing.assert_close(rows[:live], want_rows[:live], rtol=0, atol=0)
    assert not rows[live:].any()
    torch.testing.assert_close(inverse.reshape(-1).long()[pairs.order],
                               torch.arange(t * k), rtol=0, atol=0)
    # the SwiGLU and its gradient: the eager fp32 formula, rounded alike
    f = 8
    h = torch.randn(t * k, 2 * f, generator=g).to(dtype).requires_grad_(True)
    act = er.swiglu_rows_plain(h.detach(), pairs.offs)
    want_act = (torch.nn.functional.silu(h[:, :f].float()) * h[:, f:].float()).to(dtype)
    torch.testing.assert_close(act[:live], want_act[:live], rtol=0, atol=0)
    dact = torch.randn(t * k, f, generator=g).to(dtype)
    dh = er.swiglu_rows_bwd_plain(h.detach(), dact, pairs.offs)
    want_dh, = torch.autograd.grad(want_act, h, dact)
    torch.testing.assert_close(dh[:live], want_dh[:live])
    assert not dh[live:].any()
    # the combine and its gradients against the inverse gather and the bmm
    # (fp32 gates: the same rounding in fp32, finer in bf16)
    out = torch.randn(t * k, 16, generator=g).to(dtype).requires_grad_(True)
    gl = gates.clone().requires_grad_(True)
    held = (inverse < live).float()
    per_pair = out.float().index_select(0, inverse.reshape(-1).long()).view(t, k, -1)
    want_y = torch.bmm((gl * held)[:, None, :], per_pair)[:, 0]
    y = er.expert_combine_plain(out.detach(), inverse, pairs.offs, gates, torch.float32)
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(y, want_y, **TOL)
    dy = torch.randn(t, 16, generator=g)
    d_out, d_gates = er.expert_combine_bwd_plain(out.detach(), inverse, pairs.offs,
                                                 gates, dy)
    want_dout, want_dgates = torch.autograd.grad(want_y, (out, gl), dy)
    torch.testing.assert_close(d_gates, want_dgates, **TOL)
    torch.testing.assert_close(d_out.float(), want_dout.float(), **tol)
    # the gather's gradient: the ungated combine, each token's held rows summed
    dx = er.expert_combine_plain(d_out, inverse, pairs.offs, None, torch.float32)
    want_dx = torch.zeros(t, 16).index_add(
        0, pairs.order[:live] // k, d_out[:live].float())
    torch.testing.assert_close(dx, want_dx, **TOL)


def test_the_trainer_reads_the_live_row_share_from_the_loads():
    from dedloc_tpu_torch.roles.trainer import _record_expert_loads
    from dedloc_tpu_torch.telemetry.registry import Telemetry

    tele = Telemetry()
    held = torch.tensor([[6.0, 2.0], [0.0, 4.0]])  # two layers, two held experts
    _record_expert_loads(tele, held, rows_given=96)
    assert tele.gauges["moe.live_row_share"].value == 12 / 96
    assert tele.gauges["moe.expert_load_max"].value == 6 / 3
    event = tele.events[-1]
    assert event["event"] == "moe.expert_loads" and event["live_row_share"] == 12 / 96
    assert event["pairs"] == [[6.0, 2.0], [0.0, 4.0]] and not held.any()


def test_the_balance_loss_matches_a_hand_count():
    scores = torch.tensor([[0.9, 0.1, 0.5, 0.2], [0.3, 0.8, 0.6, 0.4],
                           [0.7, 0.2, 0.1, 0.9], [0.5, 0.5, 0.4, 0.1]])
    experts = torch.tensor([[0, 2], [1, 2], [3, 0], [0, 1]])
    r = moe.TopKRouting(scores, experts, torch.ones(4, 2), torch.zeros(4))
    # two sequences of two tokens: f_i = count_i * E / (k * S), P_i the
    # mean of the normalised scores
    want = 0.0
    for rows in (slice(0, 2), slice(2, 4)):
        counts = torch.zeros(4)
        for t in experts[rows].reshape(-1):
            counts[t] += 1
        f = counts * 4 / (2 * 2)
        p = (scores[rows] / scores[rows].sum(-1, keepdim=True)).mean(0)
        want += float((f * p).sum()) / 2
    assert abs(float(moe.sequence_balance(r, 2)) - want) < 1e-6


def test_the_bias_update_follows_the_sign_rule():
    bias = torch.zeros(2, 4)
    loads = torch.tensor([[10.0, 2.0, 6.0, 6.0], [1.0, 1.0, 1.0, 5.0]])
    moe.bias_update(bias, loads, 1e-3)
    # mean 6: under-loaded experts rise, over-loaded ones fall, the mean stays
    torch.testing.assert_close(bias, torch.tensor([[-1e-3, 1e-3, 0.0, 0.0],
                                                   [1e-3, 1e-3, 1e-3, -1e-3]]))


def _naive(q, k, v):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    n = s.shape[-1]
    s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1), float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("s", [37, 64])
def test_the_causal_two_width_flash_path_against_softmax_attention(s):
    g = torch.Generator().manual_seed(s)
    q, k = (torch.randn(2, s, 3, 192, generator=g, requires_grad=True) for _ in range(2))
    v = torch.randn(2, s, 3, 128, generator=g, requires_grad=True)
    dout = torch.randn(2, s, 3, 128, generator=g)
    got = fa.flash_attention(q, k, v, causal=True)
    want = _naive(q, k, v)
    torch.testing.assert_close(got, want, **TOL)
    for a, b in zip(torch.autograd.grad(got, (q, k, v), dout),
                    torch.autograd.grad(want, (q, k, v), dout)):
        torch.testing.assert_close(a, b, **TOL)
    # the plain forward's lse is the log-sum-exp of the kept scores
    _out, lse = fa.flash_fwd_plain(q.detach(), k.detach(), v.detach(),
                                   torch.zeros(2, s), causal=True)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.detach(), k.detach()) / 192 ** 0.5
    sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(sc, -1).reshape(6, s), **TOL)


def test_one_step_through_the_flat_lamb_apply_moves_the_bias():
    cfg, model = _model(held=4, rank=1)
    params = dict(model.named_parameters())
    args = parse_config(CollaborationArguments, [
        "--dht.experiment_prefix", "x", "--training.warmup_steps", "0",
        "--training.learning_rate", "0.01", "--training.weight_decay", "0.1"])
    tx_args = args.training
    batches = [_batch(cfg, seed=s) for s in (3, 4)]
    # the program: accumulate, mean, flat apply with the bias update after it
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
    # the reference: its gradients, the per-leaf LAMB chain, the plain rule
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
    torch.testing.assert_close(model.correction_biases(), torch.stack(list(biases0.values())))
    assert not torch.equal(model.correction_biases(), torch.stack(list(_biases(
        _model(held=4, rank=1)[1], cfg).values())))


def test_packed_batches_label_the_next_token():
    b = next(packed_lm_batches(64, 2, 16, 7, median_length=5.0))
    stream = np.concatenate([b["input_ids"].reshape(-1), b["labels"][-1, -1:]])
    np.testing.assert_array_equal(b["labels"].reshape(-1), stream[1:])
    assert (b["input_ids"] == EOS_ID).any() and b["input_ids"].max() < 64


def test_the_trainer_role_runs_two_steps_on_the_tiny_twin(tmp_path, monkeypatch):
    from dedloc_tpu_torch.roles.trainer import run_trainer

    monkeypatch.setenv("DEDLOC_FORCE_CPU", "1")
    args = parse_config(CollaborationArguments, [
        "--dht.experiment_prefix", "torch-deepseek", "--dht.listen_host", "127.0.0.1",
        "--training.model_size", "deepseek-v3-tiny",
        "--training.mesh_expert_devices", "2", "--training.mesh_device_offset", "1",
        "--training.per_device_batch_size", "2", "--training.seq_length", "32",
        "--training.gradient_accumulation_steps", "2", "--training.warmup_steps", "0",
        "--training.max_local_steps", "2", "--training.save_steps", "0",
        "--training.output_dir", str(tmp_path / "out"),
        "--training.train_log_path", str(tmp_path / "train.jsonl"),
        "--optimizer.target_batch_size", "4",
        "--averager.metadata_expiration", "0.2", "--averager.min_refresh_period", "0.1",
        "--averager.default_refresh_period", "0.2", "--checkpoint.cache_dir", "none"])
    state = run_trainer(args)
    assert any("experts.gate_up_proj" in n for n in state.params)
    gate_up = next(p for n, p in state.params.items() if "experts.gate_up_proj" in n)
    assert gate_up.shape[0] == 4  # rank 1 of 2 holds 4 of the 8 experts
    records = [json.loads(line) for line in
               (tmp_path / "train.jsonl").read_text().splitlines()]
    assert records and all(np.isfinite(r["loss"]) for r in records)
    assert all(torch.isfinite(v).all() for v in state.params.values())


def test_the_trainer_refuses_streamed_text_for_the_causal_lm():
    from dedloc_tpu_torch.roles.trainer import slice_axes

    args = parse_config(CollaborationArguments, [
        "--training.model_size", "deepseek-v3-tiny",
        "--training.streaming_files", "corpus.txt"])
    with pytest.raises(ValueError, match="streaming_files"):
        slice_axes(args)
