"""On the card: latent attention's flash kernels and one Moonlight micro-step.

    python -m pytest portbench/tests -m card -s

- the three two-width kernels (q/k 192 wide, v 128 wide, causal) against
  their plain versions, at a sequence length that is not a tile multiple
  too (each output within 1e-2 of the largest reference value of its
  sample plus 1e-2 of its own, the tolerance of the port's other flash
  checks: bf16 inputs and outputs, fp32 accumulation);
- the causal forward at [2, 8192, 16, 192/128] takes at most 60% of the
  same launch without the causal flag: the tiles above the diagonal are
  skipped, not masked;
- one micro-step of the Moonlight cell's model under
  ``torch.cuda.set_sync_debug_mode("error")``: routing, sorting and the
  grouped products read nothing on the host.

Each kernel's time and error go to standard output as JSON lines."""
import json

import pytest
import torch

SHAPES = [(1, 300, 2, True), (2, 1024, 4, True), (1, 200, 2, False)]


def _inputs(b, s, h, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, s, h, 192, device="cuda", generator=g).bfloat16()
    k = torch.randn(b, s, h, 192, device="cuda", generator=g).bfloat16()
    v = torch.randn(b, s, h, 128, device="cuda", generator=g).bfloat16()
    dout = torch.randn(b, s, h, 128, device="cuda", generator=g).bfloat16()
    bias = torch.zeros(b, s, device="cuda")
    return q, k, v, dout, bias


def _close(name, got, want):
    got, want = got.float(), want.float()
    assert got.shape == want.shape, name
    assert torch.isfinite(got).all(), name
    ref = want.abs()
    atol = 1e-2 * ref.amax(dim=tuple(range(1, ref.dim())), keepdim=True)
    err = (got - want).abs()
    assert bool((err <= atol + 1e-2 * ref).all()), (name, float(err.max()))
    return float(err.max())


@pytest.mark.card
@pytest.mark.parametrize("b,s,h,causal", SHAPES)
def test_mla_flash_kernels_match_their_plain_versions(card, b, s, h, causal):
    from dedloc_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, dout, bias = _inputs(b, s, h)
    out, lse = fa.flash_fwd(q, k, v, bias, causal)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, bias, causal=causal)
    errs = {"out": _close("out", out, out_p)}
    assert float((lse - lse_p).abs().max()) < 1e-3 + 1e-5 * float(lse_p.abs().max())
    delta = fa.softmax_delta(out, dout)
    dk, dv = fa.flash_bwd_dkdv(q, k, v, bias, lse, dout, delta, causal)
    dk_p, dv_p = fa.flash_bwd_dkdv_plain(q, k, v, bias, lse, dout, delta, causal=causal)
    dq = fa.flash_bwd_dq(q, k, v, bias, lse, dout, delta, causal)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, bias, lse, dout, delta, causal=causal)
    errs.update(dk=_close("dk", dk, dk_p), dv=_close("dv", dv, dv_p),
                dq=_close("dq", dq, dq_p))
    print(json.dumps({"mla_flash_check": [b, s, h, 192, 128, causal], **errs}))


def _ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@pytest.mark.card
def test_causal_forward_skips_the_tiles_above_the_diagonal(card):
    from dedloc_tpu_torch.ops import flash_attention as fa
    from portbench.counts import causal_flash, h100

    b, s, h = 2, 8192, 16
    q, k, v, dout, bias = _inputs(b, s, h)
    times = {c: _ms(lambda c=c: fa.flash_fwd(q, k, v, bias, c)) for c in (False, True)}
    out, lse = fa.flash_fwd(q, k, v, bias, True)
    delta = fa.softmax_delta(out, dout)
    dkdv = _ms(lambda: fa.flash_bwd_dkdv(q, k, v, bias, lse, dout, delta, True))
    dq = _ms(lambda: fa.flash_bwd_dq(q, k, v, bias, lse, dout, delta, True))
    props = torch.cuda.get_device_properties(0)
    bounds = causal_flash.bounds(b, s, h, 192, 128, h100.exp_per_s(
        props.multi_processor_count, 1980.0))
    print(json.dumps({"mla_flash_ms": {"fwd_full": times[False], "fwd_causal": times[True],
                                       "bwd_dkdv": dkdv, "bwd_dq": dq},
                      "bound_ms": {k_: v_ * 1e3 for k_, v_ in bounds.items()},
                      "card": torch.cuda.get_device_name(0)}))
    assert times[True] <= 0.6 * times[False], times


@pytest.mark.card
def test_a_moonlight_micro_step_reads_nothing_on_the_host(card):
    from dedloc_tpu_torch.models.deepseek_v3 import DeepseekV3Config
    from dedloc_tpu_torch.parallel.train_step import make_accumulate_step, zeros_like_grads
    from dedloc_tpu_torch.roles.common import build_loss_fn, build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, model = build_model("moonlight-16b-a3b", device="cuda", seed=0,
                             overrides=dict(num_hidden_layers=3, vocab_size=20480,
                                            experts_held=8))
    assert isinstance(cfg, DeepseekV3Config)
    params = dict(model.named_parameters())
    step = make_accumulate_step(build_loss_fn(model))
    g = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (1, 2048), device="cuda", generator=g)
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
