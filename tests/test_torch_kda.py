"""The KDA chunk op (``ops/kda.py``) on the CPU: its plain mirror (the
kernels' algorithm, forward and hand-written backward) against the token
recurrence, forward and every input's gradient, at several chunk lengths
and sequence lengths that are not a chunk multiple; the write strength at 0
and 1; a decay whose chunk sum falls far below fp32's ``exp`` range; the
benchmark reference's chunked form against the recurrence; and the NoPE
option of DeepSeek-V3's latent attention, with the RoPE path unchanged."""
import math

import pytest
import torch

from dedloc_tpu_torch.models import deepseek_v3 as ds
from dedloc_tpu_torch.ops import kda
from dedloc_tpu_torch.testing import plain_kimi_linear as plain
from portbench.reference import kimi_linear as bench_ref

SCALE = 0.25
# the mirror and the recurrence compute the same sums in other orders in
# fp32; each tensor is O(1): the gaps are rounding
TOL = dict(rtol=2e-4, atol=2e-5)


def _inputs(b=2, s=37, h=3, dk=16, dv=32, decay=1.0, seed=0, beta=None):
    g = torch.Generator().manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn(b, s, h, dk, generator=g), dim=-1)
    k = torch.nn.functional.normalize(torch.randn(b, s, h, dk, generator=g), dim=-1)
    v = torch.randn(b, s, h, dv, generator=g)
    logd = -torch.rand(b, s, h, dk, generator=g) * decay
    bt = torch.rand(b, s, h, generator=g) if beta is None else torch.full((b, s, h), beta)
    return q, k, v, logd, bt


def _recurrence_grads(inputs, do):
    leaves = [x.double().requires_grad_(True) for x in inputs]
    out = kda.kda_recurrent(*leaves, SCALE)
    return out.float(), [x.float() for x in torch.autograd.grad(out, leaves, do.double())]


def _mirror(inputs, do, chunk):
    o, norm, saved = kda.kda_fwd_plain(*inputs, SCALE, chunk)
    return o, norm, kda.kda_bwd_plain(*inputs, SCALE, saved, do, chunk)


@pytest.mark.parametrize("chunk,s", [(16, 37), (16, 48), (8, 21), (32, 70)])
def test_the_mirror_matches_the_recurrence(chunk, s):
    inputs = _inputs(s=s, seed=s)
    do = torch.randn(inputs[2].shape, generator=torch.Generator().manual_seed(1))
    want, want_grads = _recurrence_grads(inputs, do)
    got, _norm, grads = _mirror(inputs, do, chunk)
    torch.testing.assert_close(got, want, **TOL)
    for name, a, b in zip(("q", "k", "v", "g", "beta"), grads, want_grads):
        torch.testing.assert_close(a, b, **TOL, msg=name)


def test_the_op_on_the_cpu_is_the_mirror_with_autograd():
    inputs = _inputs(s=29)
    do = torch.randn(inputs[2].shape, generator=torch.Generator().manual_seed(2))
    leaves = [x.clone().requires_grad_(True) for x in inputs]
    o, norm = kda.kda_chunk(*leaves, SCALE)
    grads = torch.autograd.grad(o, leaves, do)
    auto = [x.clone().requires_grad_(True) for x in inputs]
    o2, norm2 = kda.kda_chunk_plain(*auto, SCALE)
    for a, b in zip(grads, torch.autograd.grad(o2, auto, do)):
        torch.testing.assert_close(a, b, **TOL)
    torch.testing.assert_close(o, o2, **TOL)
    torch.testing.assert_close(norm, norm2, **TOL)
    assert not norm.requires_grad


@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_the_write_strength_at_its_ends(beta):
    inputs = _inputs(s=40, beta=beta, seed=5)
    do = torch.randn(inputs[2].shape, generator=torch.Generator().manual_seed(3))
    want, want_grads = _recurrence_grads(inputs, do)
    got, norm, grads = _mirror(inputs, do, 16)
    torch.testing.assert_close(got, want, **TOL)
    for a, b in zip(grads, want_grads):
        torch.testing.assert_close(a, b, **TOL)
    if beta == 0.0:  # nothing is written: the state stays 0
        assert not got.any() and not norm.any()


def test_a_state_carried_across_chunks():
    # the second chunk's output depends on the first chunk's writes alone
    # when its own write strength is 0
    q, k, v, g, beta = _inputs(b=1, s=32, seed=7)
    beta[:, 16:] = 0.0
    out = kda.kda_fwd_plain(q, k, v, g, beta, SCALE, 16)[0]
    state = torch.zeros(3, 16, 32)
    for t in range(16):
        state = state * g[0, t].exp()[..., None]
        pred = torch.einsum("hkv,hk->hv", state, k[0, t])
        state = state + k[0, t][..., None] * (beta[0, t][:, None] * (v[0, t] - pred))[:, None]
    for t in range(16, 32):
        state = state * g[0, t].exp()[..., None]
        want = SCALE * torch.einsum("hkv,hk->hv", state, q[0, t])
        torch.testing.assert_close(out[0, t], want, **TOL)
    assert out[0, 16:].abs().max() > 1e-3


def test_a_decay_far_below_exps_range_stays_finite():
    # g about -7 a token: a 16-token chunk's decay sums to about -112, so
    # e^{-G} would overflow fp32; the per-channel differences never do
    inputs = _inputs(s=40, decay=14.0, seed=9)
    assert float(inputs[3][:, :16].sum(1).min()) < -100
    do = torch.randn(inputs[2].shape, generator=torch.Generator().manual_seed(4))
    want, want_grads = _recurrence_grads(inputs, do)
    got, norm, grads = _mirror(inputs, do, 16)
    assert torch.isfinite(got).all() and torch.isfinite(norm).all()
    torch.testing.assert_close(got, want, **TOL)
    for a, b in zip(grads, want_grads):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, **TOL)


# decay 3: a 64-token chunk sums to about -96 (per-channel path), a 16- or
# 32-token one to -24 or -48 (the factored path, every chunk at once); 300
# tokens of 16 are 19 chunks, the state pass's 4 groups of 5 with one padded
@pytest.mark.parametrize("chunk,s,decay", [(64, 150, 3.0), (16, 37, 3.0),
                                           (bench_ref.CHUNK, 100, 3.0),
                                           (bench_ref.CHUNK, 70, 14.0),
                                           (16, 300, 3.0)])
def test_the_benchmark_references_chunked_form_matches_the_recurrence(chunk, s, decay):
    q, k, v, g, beta = (x[0] for x in _inputs(b=1, s=s, decay=decay, seed=11))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, g, beta)]
    got = bench_ref.kda_chunked(*leaves, SCALE, chunk)
    ref_leaves = [x.clone().requires_grad_(True) for x in (q, k, v, g, beta)]
    want = plain.recurrence(*ref_leaves, SCALE)
    torch.testing.assert_close(got, want, **TOL)
    do = torch.randn(want.shape, generator=torch.Generator().manual_seed(6))
    for a, b in zip(torch.autograd.grad(got, leaves, do),
                    torch.autograd.grad(want, ref_leaves, do)):
        torch.testing.assert_close(a, b, **TOL)


def test_the_benchmark_draws_every_kda_leaf():
    c = {f.name: getattr(cfg, f.name) for cfg in [ds_tiny()]
         for f in cfg.__dataclass_fields__.values()}
    spec = bench_ref.spec(c)
    weights = bench_ref.draw(spec, 2 ** 40 + 1, "cpu")
    assert [n for n, *_ in spec] == list(weights)
    conv = weights["model.layers.0.self_attn.q_conv1d.weight"]
    assert conv.abs().max() <= 0.5 and conv.std() > 0.2
    a_log = weights["model.layers.0.self_attn.A_log"]
    assert bool(((a_log >= 0) & (a_log <= math.log(16))).all())
    dt = torch.nn.functional.softplus(weights["model.layers.0.self_attn.dt_bias"])
    assert bool(((dt >= 1e-3 * 0.999) & (dt <= 1e-1 * 1.001)).all())
    again = bench_ref.draw(spec, 2 ** 40 + 1, "cpu")
    assert all(torch.equal(weights[n], again[n]) for n in weights)


def ds_tiny():
    from dedloc_tpu_torch.models.kimi_linear import KimiLinearConfig

    return KimiLinearConfig.named("kimi-linear-tiny")


def _attention(nope: bool):
    cfg = ds.DeepseekV3Config.named("deepseek-v3-tiny", mla_use_nope=nope)
    torch.manual_seed(0)
    attn = ds.Attention(cfg)
    for p in attn.parameters():
        torch.nn.init.normal_(p, std=0.3)
    return cfg, attn


def test_the_nope_latent_attention_skips_only_the_rotation():
    cfg, attn = _attention(nope=True)
    h = torch.randn(2, 12, cfg.hidden_size, generator=torch.Generator().manual_seed(1))
    got = attn(h, cfg, None, None)
    P = {"self_attn." + n: p for n, p in attn.named_parameters()}
    c = {f.name: getattr(cfg, f.name) for f in cfg.__dataclass_fields__.values()}
    want = torch.stack([plain.mla_nope(P, "", row, c) for row in h])
    torch.testing.assert_close(got, want, **TOL)
    # the rotary path still rotates: with the same weights its output differs
    rope_cfg = ds.DeepseekV3Config.named("deepseek-v3-tiny")
    cos, sin = ds.rope_tables(12, rope_cfg.qk_rope_head_dim, rope_cfg.rope_theta, "cpu")
    assert not torch.allclose(attn(h, rope_cfg, cos, sin), got, atol=1e-4)


def test_the_rope_latent_attention_is_unchanged():
    from dedloc_tpu_torch.testing import plain_deepseek_v3 as plain_ds

    cfg, attn = _attention(nope=False)
    h = torch.randn(2, 12, cfg.hidden_size, generator=torch.Generator().manual_seed(2))
    cos, sin = ds.rope_tables(12, cfg.qk_rope_head_dim, cfg.rope_theta, "cpu")
    got = attn(h, cfg, cos, sin)
    P = {"self_attn." + n: p for n, p in attn.named_parameters()}
    c = {f.name: getattr(cfg, f.name) for f in cfg.__dataclass_fields__.values()}
    want = torch.stack([plain_ds._mla(P, "", row, c, False) for row in h])
    torch.testing.assert_close(got, want, **TOL)
