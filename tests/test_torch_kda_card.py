"""On the card: the KDA chunk kernels (``ops/csrc/kda.cu`` through
``ops/kda.py``) and one Kimi Linear micro-step.

    python -m pytest tests/test_torch_kda_card.py -m card --noconftest -s

(``--noconftest``: the directory's conftest loads JAX, which the card's
machine does not need.) Skipped without a CUDA device.

- the four kernels, forward and backward, against the plain chunked path
  (``kda_fwd_plain`` / ``kda_bwd_plain``: the same algorithm in fp32 on the
  bf16-rounded inputs) at the cell's ``[2, 8192, 32, 128, 128]``, at a
  sequence length that is not a chunk multiple, and with a decay whose
  chunk sums fall far below -88 (where ``e^{-G}`` alone would overflow
  fp32);
- two backward runs bitwise equal (no atomics);
- one ``kimi-linear-48b-a3b`` micro-step (two periods of 3 KDA + 1 MLA
  layers at the published widths, 8 experts held) under
  ``torch.cuda.set_sync_debug_mode("error")``: nothing reads the host;
- each kernel's CUDA-graph replay time at the cell's shape against its
  ``portbench/counts/kda.py`` bound, printed as a JSON line.
"""
import json

import pytest
import torch

D = 128
# Every product with the state takes bf16 inputs (8 bits of mantissa: a
# relative rounding of 2^-9 an operand) and accumulates in fp32; the state
# recurrence is contractive (decay <= 1 and I - β k kᵀ of norm <= 1), so
# the rounding does not grow over the chunks. An output or gradient is
# within 2% of its tensor's largest value element by element, and its
# relative L2 error within 1%: about five bf16 roundings.
REL_MAX, REL_L2 = 2e-2, 1e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest "
                    "tests/test_torch_kda_card.py -m card --noconftest")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, s, h, seed=0, strong=False):
    """q, k L2-normalised and v in bf16; the decay as the cell's initial
    weights give it (up to ~1.6 a token on the fastest channels) or, with
    ``strong``, up to 14 a token (a chunk's sum far below -88); β in
    (0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=g)
    q = torch.nn.functional.normalize(rnd(b, s, h, D), dim=-1).bfloat16()
    k = torch.nn.functional.normalize(rnd(b, s, h, D), dim=-1).bfloat16()
    v = rnd(b, s, h, D).bfloat16()
    a = torch.exp(torch.rand(h, 1, device="cuda", generator=g) * 2.77)  # U(1, 16) in log
    logd = -a * torch.nn.functional.softplus(rnd(b, s, h, D) * 0.5 - 4.0)
    if strong:
        logd = -14.0 * torch.rand(b, s, h, D, device="cuda", generator=g)
    beta = torch.rand(b, s, h, device="cuda", generator=g)
    do = rnd(b, s, h, D).bfloat16()
    return q, k, v, logd.contiguous(), beta, do


def _close(name, got, want):
    got, want = got.float(), want.float()
    assert got.shape == want.shape, name
    assert bool(torch.isfinite(got).all()), name
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    rel_l2 = float((got - want).norm() / want.norm().clamp_min(1e-30))
    assert err <= REL_MAX * scale and rel_l2 <= REL_L2, (name, err, scale, rel_l2)
    return {"max_err": err, "max_ref": scale, "rel_l2": rel_l2}


@pytest.mark.card
@pytest.mark.parametrize("b,s,h,strong", [(2, 8192, 32, False), (1, 1000, 4, False),
                                          (1, 1000, 4, True)])
def test_the_kernels_match_the_plain_chunked_path(card, b, s, h, strong):
    from dedloc_tpu_torch.ops import kda

    q, k, v, g, beta, do = _inputs(b, s, h, strong=strong)
    scale = D ** -0.5
    o, norm, saved = kda.kda_fwd(q, k, v, g, beta, scale)
    grads = kda.kda_bwd(q, k, v, g, beta, scale, saved, do)
    torch.cuda.synchronize()
    plain_in = [x.float() for x in (q, k, v, g, beta)]
    with torch.no_grad():
        o_p, norm_p, saved_p = kda.kda_fwd_plain(*plain_in, scale)
        errs = {"o": _close("o", o, o_p), "norm": _close("norm", norm, norm_p)}
        grads_p = kda.kda_bwd_plain(*plain_in, scale, saved_p, do.float())
        del saved_p
    for name, a, r in zip(("dq", "dk", "dv", "dg", "dbeta"), grads, grads_p):
        errs[name] = _close(name, a, r)
    print(json.dumps({"kda_check": [b, s, h, D, D, kda.CHUNK], "strong_decay": strong,
                      **errs}))


@pytest.mark.card
def test_two_backward_runs_are_bitwise_equal(card):
    from dedloc_tpu_torch.ops import kda

    q, k, v, g, beta, do = _inputs(2, 8192, 32, seed=1)
    o, _norm, saved = kda.kda_fwd(q, k, v, g, beta, D ** -0.5)
    first = kda.kda_bwd(q, k, v, g, beta, D ** -0.5, saved, do)
    again = kda.kda_bwd(q, k, v, g, beta, D ** -0.5, saved, do)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.card
def test_a_kimi_linear_micro_step_reads_nothing_on_the_host(card):
    from dedloc_tpu_torch.models.kimi_linear import KimiLinearConfig
    from dedloc_tpu_torch.parallel.train_step import make_accumulate_step, zeros_like_grads
    from dedloc_tpu_torch.roles.common import build_loss_fn, build_model

    cfg, model = build_model("kimi-linear-48b-a3b", device="cuda", seed=0,
                             moe_experts_held=8,
                             overrides=dict(num_hidden_layers=8, vocab_size=20480))
    assert isinstance(cfg, KimiLinearConfig)
    params = dict(model.named_parameters())
    step = make_accumulate_step(build_loss_fn(model))
    g = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (2, 8192), device="cuda", generator=g)
    batch = {"input_ids": ids, "labels": torch.roll(ids, -1, 1)}
    acc = zeros_like_grads(params)
    step(params, acc, 0, batch)  # warm: the kernels build, the allocator fills
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        acc, n, metrics = step(params, acc, 1, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert n == 2 and bool(torch.isfinite(metrics["loss"]))
    assert metrics["kda_state_norm"].shape == (6,)
    print(json.dumps({"kimi_micro_step": {"loss": float(metrics["loss"]),
                                          "state_norms": metrics["kda_state_norm"].tolist(),
                                          "peak_gib": torch.cuda.max_memory_allocated()
                                          / 2 ** 30}}))


def _replay_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@pytest.mark.card
def test_each_kernels_replay_time_against_its_bound(card):
    from dedloc_tpu_torch.ops import kda
    from portbench.counts import kda as counts

    b, s, h = 2, 8192, 32
    q, k, v, g, beta, do = _inputs(b, s, h, seed=2)
    scale = D ** -0.5
    o, _norm, (s0, u, m, w) = kda.kda_fwd(q, k, v, g, beta, scale)
    ss = torch.empty(b * h, D // kda.BV, device="cuda")
    dh, du = torch.empty_like(s0), torch.empty_like(u)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dg, dbeta = torch.empty_like(g), torch.empty_like(beta)
    calls = {
        "kda_fwd_intra_kernel": lambda: kda.launch_fwd_intra(q, k, v, g, beta, w, u, m),
        "kda_fwd_state_kernel": lambda: kda.launch_fwd_state(q, k, g, w, u, m, o, s0, ss,
                                                             scale),
        "kda_bwd_state_kernel": lambda: kda.launch_bwd_state(q, k, g, w, m, do, dh, du,
                                                             scale),
        "kda_bwd_intra_kernel": lambda: kda.launch_bwd_intra(
            q, k, v, g, beta, s0, dh, u, du, do, dq, dk, dv, dg, dbeta, scale),
    }
    bounds = counts.bounds(b, s, h, D, D, kda.CHUNK)
    rows = {}
    for name in counts.KERNELS:
        ms = _replay_ms(calls[name])
        rows[name] = {"replay_ms": ms, "bound_ms": bounds[name] * 1e3,
                      "roofline_pct": 100 * bounds[name] * 1e3 / ms}
    print(json.dumps({"kda_kernels": rows, "shape": [b, s, h, D, D, kda.CHUNK],
                      "card": torch.cuda.get_device_name(0)}))
    assert all(r["roofline_pct"] <= 105 for r in rows.values()), rows
