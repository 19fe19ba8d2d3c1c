"""Kimi Linear causal LM (Kimi-Linear-48B-A3B) as plain PyTorch, in float32.

A frozen copy of the port's ``testing/plain_kimi_linear.py``, the plain
reference of its ``models/kimi_linear.py``, with two changes so that the
cell's sizes fit and end in minutes: KDA is computed in the chunked form
(``kda_chunked``: the same mathematics arranged by chunks of ``CHUNK``
tokens; where every chunk's decay sums to more than -80 the decay
products ``e^{G_t - G_s}`` are taken as ``e^{G_t} e^{-G_s}``, all chunks
at once, else per channel a chunk at a time, recomputed in the backward),
and ``blocks`` (latent attention a few heads and rows at a time, each
layer recomputed in the backward, as ``deepseek_v3.py`` does). The port's tests tie the
chunked form to the token recurrence. Written from the paper (Kimi
Linear, arXiv 2510.26692 §3) and the published configuration:
pre-RMSNorm layers whose token mixer is Kimi Delta Attention (KDA) in the
layers ``kda_layers`` names (1-based) and latent attention without a
rotary embedding in the others; then DeepSeek-V3's dense first layer and
expert layers, final RMSNorm, untied head, next-token cross-entropy plus
the sequence-wise balance loss, and the correction-bias update, all taken
from ``deepseek_v3.py``.

KDA, for the normed ``x [S, H]`` of one sequence: ``q, k, v =
SiLU(conv(W x))`` with ``conv`` the causal depthwise ``F.conv1d``, ``q``
and ``k`` L2-normalised per head, ``g = -exp(A_log[h]) softplus(W_fb W_fa
x + dt_bias)``, ``β = sigmoid(W_b x)``, then ``S_t = (I - β_t k_t k_tᵀ)
Diag(exp g_t) S_{t-1} + β_t k_t v_tᵀ``, ``o_t = d^-1/2 S_tᵀ q_t``, the
gated RMSNorm ``RMSNorm(o) ⊙ sigmoid(W_gb W_ga x)`` per head and ``W_o``.

No kernel of the port, no mixed precision, no grouping: every operation
runs in the dtype of the tensors it is given (float32 with TF32 off for
the reference). Departures from the published model, shared with the
program:

- one expert-parallel rank's share of the experts (``deepseek_v3.py``);
- no mask between the documents of a packed row, and no reset of the KDA
  state at a document's start.

The configuration uses DeepSeek-V3's key names (``n_routed_experts``,
``num_experts_per_tok``, ``n_shared_experts``) plus ``kda_layers``,
``kda_heads``, ``kda_head_dim``, ``short_conv_kernel_size`` and
``l2_norm_eps``. Parameter names are the program's; ``spec`` lists them
with their shapes and init kinds, and ``draw`` draws them (``init.draw``
for the kinds it knows, then KDA's own).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from portbench.reference import deepseek_v3 as ds
from portbench.reference import init

Tensors = Dict[str, torch.Tensor]
LAYER = ds.LAYER
CHUNK = 32  # tokens a chunk of the chunked KDA form
KINDS = ("conv", "a_log", "dt_bias")  # the init kinds ``draw`` adds


def is_kda(c: dict, layer: int) -> bool:
    return layer + 1 in c["kda_layers"]


def kda_spec(prefix: str, c: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """The KDA mixer's leaves: N(0, std^2) matrices, ``conv`` kernels
    (U(-1/2, 1/2)), ``a_log`` (log U(1, 16)), ``dt_bias`` (the inverse
    softplus of a log-uniform draw on [1e-3, 1e-1]), the gated norm's
    scale 1."""
    h, nh, d, std = c["hidden_size"], c["kda_heads"], c["kda_head_dim"], c["initializer_range"]
    w = nh * d
    p = prefix + "self_attn."
    mat = lambda name, n_in, n_out: (p + name + ".weight", (n_out, n_in), "normal", std)
    conv = lambda name: (p + name + ".weight", (w, c["short_conv_kernel_size"]),
                         "conv", 0.0)
    return [mat("q_proj", h, w), mat("k_proj", h, w), mat("v_proj", h, w),
            conv("q_conv1d"), conv("k_conv1d"), conv("v_conv1d"),
            (p + "A_log", (nh,), "a_log", 0.0), mat("f_a_proj", h, d),
            mat("f_b_proj", d, w), (p + "dt_bias", (w,), "dt_bias", 0.0),
            mat("b_proj", h, nh), mat("g_a_proj", h, d), mat("g_b_proj", d, w),
            (p + "o_norm.weight", (d,), "ones", 0.0), mat("o_proj", w, h)]


def spec(c: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """``plain_deepseek_v3.spec`` with each KDA layer's attention leaves
    replaced by ``kda_spec``'s."""
    out = []
    for entry in ds.spec(c):
        name = entry[0]
        if name.startswith("model.layers."):
            i = int(name.split(".")[2])
            prefix = LAYER.format(i)
            if is_kda(c, i) and name.startswith(prefix + "self_attn."):
                if name == prefix + "self_attn.q_proj.weight":
                    out += kda_spec(prefix, c)
                continue
        out.append(entry)
    return out


def short_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Causal depthwise convolution of ``x [S, C]`` over time by ``weight
    [C, W]`` (a depthwise ``nn.Conv1d``'s kernel without its middle axis)."""
    taps = weight.shape[-1]
    y = F.conv1d(x.t()[None], weight[:, None], padding=taps - 1, groups=x.shape[1])
    return y[0, :, :x.shape[0]].t()


def _ends(q, k, big_g):
    """(Q e^G, K e^{G_C - G}, e^{G_C}) of chunks ``[.., C, ·]``."""
    last = big_g[..., -1:, :]
    return q * big_g.exp(), k * (last - big_g).exp(), last[..., 0, :].exp()


def _solve(a, beta, k_g, v):
    """(W, Ũ) = ``T diag(β) (K e^G)``, ``T diag(β) V`` with ``T = (I +
    A)^-1``, solved in float32 whatever the dtype (the triangular solve has
    no bfloat16)."""
    c = a.shape[-1]
    eye = torch.eye(c, device=a.device)
    t = torch.linalg.solve_triangular(eye + a.float(), eye.expand(a.shape), upper=False,
                                      unitriangular=True).to(a.dtype)
    return t @ (beta[..., None] * k_g), t @ (beta[..., None] * v)


def _chunk_algebra(q, k, v, g, beta):
    """One chunk's own algebra, ``[heads, C, ·]`` inputs: (Q e^G, K
    e^{G_C - G}, e^{G_C}, M, W, Ũ), with ``G`` the chunk's cumulative
    decay, ``A_ts = β_t Σ_c k_tc k_sc e^{G_tc - G_sc}`` (s < t), ``M_ts =
    Σ_c q_tc k_sc e^{G_tc - G_sc}`` (s <= t), each ``e^{G_tc - G_sc}``
    formed per channel."""
    big_g = g.cumsum(1)
    c = g.shape[1]
    lower = torch.ones(c, c, dtype=torch.bool, device=g.device).tril()
    diff = big_g[:, :, None, :] - big_g[:, None, :, :]
    e = diff.masked_fill(~lower[..., None], float("-inf")).exp()
    a = beta[..., None] * (k[:, :, None] * k[:, None] * e).sum(-1) * lower.tril(-1)
    m = (q[:, :, None] * k[:, None] * e).sum(-1)
    w, u = _solve(a, beta, k * big_g.exp(), v)
    return (*_ends(q, k, big_g), m, w, u)


def _factored_algebra(q, k, v, big_g, beta):
    """Every chunk's algebra at once, ``[heads, N, C, ·]``, with ``e^{G_tc -
    G_sc} = e^{G_tc} e^{-G_sc}`` (in range where no chunk's decay sums
    below -80)."""
    c = q.shape[-2]
    lower = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    eg, k_neg = big_g.exp(), k * (-big_g).exp()
    k_g = k * eg
    a = beta[..., None] * (k_g @ k_neg.transpose(-1, -2)) * lower.tril(-1)
    m = (q * eg) @ k_neg.transpose(-1, -2) * lower
    w, u = _solve(a, beta, k_g, v)
    return (*_ends(q, k, big_g), m, w, u)


def kda_chunked(q, k, v, g, beta, scale, chunk: int = CHUNK):
    """``o [S, heads, d_v]`` of one sequence's ``[S, heads, ·]`` inputs: the
    gated delta rule a chunk at a time, ``U = Ũ - W S``, ``O = scale (Q
    e^G S + M U)``, ``S <- e^{G_C} S + (K e^{G_C - G})ᵀ U``. Each chunk's
    algebra comes from ``_factored_algebra``, all chunks at once, where
    every chunk's decay sums to more than -80 (one host read decides), else
    from ``_chunk_algebra`` a chunk at a time (recomputed in the
    backward)."""
    s, nh, d = q.shape
    n = -(-s // chunk)
    pad = n * chunk - s  # rows of zeros: q = k = v = g = β = 0 leave the state
    parts = [F.pad(x, (0, 0) * (x.dim() - 1) + (0, pad)) if pad else x
             for x in (q, k, v, g, beta[..., None])]
    qc, kc, vc, gc, bc = (x.transpose(0, 1).reshape(nh, n, chunk, x.shape[-1])
                          for x in parts)
    bc = bc[..., 0]
    big_g = gc.cumsum(2)
    if bool(big_g[:, :, -1].min() > -80.0):
        every = _factored_algebra(qc, kc, vc, big_g, bc)
        # a chunk's slices by one unbind each: a slice taken per chunk would
        # give each chunk's gradient at the size of every chunk's
        qg, kend, gend, m, w, u_t = (x.unbind(1) for x in every)
    else:
        per = [checkpoint(_chunk_algebra, qc[:, i], kc[:, i], vc[:, i], gc[:, i], bc[:, i],
                          use_reentrant=False) for i in range(n)]
        qg, kend, gend, m, w, u_t = zip(*per)
    state = q.new_zeros(nh, d, v.shape[-1])
    out = []
    for i in range(n):
        u = u_t[i] - w[i] @ state
        out.append(scale * (qg[i] @ state + m[i] @ u))
        state = gend[i][..., None] * state + kend[i].transpose(-1, -2) @ u
    return torch.cat(out, 1).transpose(0, 1)[:s]


def mixer_inputs(P: Tensors, p: str, x: torch.Tensor, c: dict):
    """(q, k, v, g, β) of one sequence's KDA layer, fp32, ``[S, heads, ·]``."""
    s, nh, d = x.shape[0], c["kda_heads"], c["kda_head_dim"]
    a = p + "self_attn."
    qkv = [F.silu(short_conv(x @ P[a + n + "_proj.weight"].t(), P[a + n + "_conv1d.weight"]))
           .view(s, nh, d) for n in "qkv"]
    eps = c["l2_norm_eps"]
    q, k = (y * torch.rsqrt(y.pow(2).sum(-1, keepdim=True) + eps) for y in qkv[:2])
    f = (x @ P[a + "f_a_proj.weight"].t()) @ P[a + "f_b_proj.weight"].t()
    g = -P[a + "A_log"].exp()[:, None] * F.softplus((f + P[a + "dt_bias"]).view(s, nh, d))
    beta = torch.sigmoid(x @ P[a + "b_proj.weight"].t())
    return q, k, qkv[2], g, beta


def mixer_output(P: Tensors, p: str, x: torch.Tensor, o: torch.Tensor, c: dict):
    """The gated RMSNorm and ``W_o`` of one sequence's KDA output ``o``."""
    s, nh, d = o.shape
    a = p + "self_attn."
    gate = (x @ P[a + "g_a_proj.weight"].t()) @ P[a + "g_b_proj.weight"].t()
    o = ds.rms_norm(o, P[a + "o_norm.weight"], c["rms_norm_eps"]) * torch.sigmoid(
        gate.view(s, nh, d))
    return o.reshape(s, nh * d) @ P[a + "o_proj.weight"].t()


def _kda(P, p, x, c):
    q, k, v, g, beta = mixer_inputs(P, p, x, c)
    o = kda_chunked(q, k, v, g, beta, 1.0 / math.sqrt(c["kda_head_dim"]))
    return mixer_output(P, p, x, o, c)


def mla_nope(P, p, h, c, blocks: bool = False):
    """Latent attention of one sequence ``h [S, H]`` with no rotary
    embedding: the 64 ``rope`` columns of q and of the shared ``k_pe``
    enter the 192-wide scores as they are."""
    s = h.shape[0]
    nh, nope, rdim, dv = (c["num_attention_heads"], c["qk_nope_head_dim"],
                          c["qk_rope_head_dim"], c["v_head_dim"])
    q = (h @ P[p + "self_attn.q_proj.weight"].t()).view(s, nh, nope + rdim)
    kv_a = h @ P[p + "self_attn.kv_a_proj_with_mqa.weight"].t()
    c_kv = ds.rms_norm(kv_a[:, :c["kv_lora_rank"]], P[p + "self_attn.kv_a_layernorm.weight"],
                       c["rms_norm_eps"])
    k_pe = kv_a[:, c["kv_lora_rank"]:].view(s, 1, rdim)
    kv = (c_kv @ P[p + "self_attn.kv_b_proj.weight"].t()).view(s, nh, nope + dv)
    k = torch.cat([kv[..., :nope], k_pe.expand(s, nh, rdim)], -1)
    o = ds.attention(q.transpose(0, 1), k.transpose(0, 1), kv[..., nope:].transpose(0, 1),
                     blocks)
    return o.transpose(0, 1).reshape(s, nh * dv) @ P[p + "self_attn.o_proj.weight"].t()


def _layer(P, i, x, bias, c, blocks):
    p = LAYER.format(i)
    eps = c["rms_norm_eps"]
    h = ds.rms_norm(x, P[p + "input_layernorm.weight"], eps)
    x = x + (_kda(P, p, h, c) if is_kda(c, i) else mla_nope(P, p, h, c, blocks))
    h = ds.rms_norm(x, P[p + "post_attention_layernorm.weight"], eps)
    if bias is None:
        return x + ds._swiglu(P, p + "mlp", h), x.new_zeros(())
    y, balance, loads = ds._moe(P, p, h, bias, c)
    return x + y, balance, loads


def hidden(P: Tensors, biases: Dict[int, torch.Tensor], ids: torch.Tensor, c: dict,
           blocks: bool = False):
    """(the final-normed hidden states ``[S, H]`` of one sequence, its balance
    loss summed over the expert layers, its loads ``[L_moe, E]``)."""
    x = P["model.embed_tokens.weight"][ids.long()]
    balance, loads = 0.0, []
    for i in range(c["num_hidden_layers"]):
        bias = biases.get(i)
        if blocks:
            out = checkpoint(_layer, P, i, x, bias, c, blocks, use_reentrant=False)
        else:
            out = _layer(P, i, x, bias, c, blocks)
        x = out[0]
        if bias is not None:
            balance = balance + out[1]
            loads.append(out[2])
    h = ds.rms_norm(x, P["model.final_layernorm.weight"], c["rms_norm_eps"])
    return h, balance, torch.stack(loads)


def logits(P: Tensors, biases: Dict[int, torch.Tensor], ids: torch.Tensor, c: dict
           ) -> torch.Tensor:
    """The next-token logits ``[B, S, V]``."""
    return torch.stack([hidden(P, biases, row, c)[0] @ P["lm_head.weight"].t()
                        for row in ids])


def loss(P: Tensors, biases: Dict[int, torch.Tensor], batch: Tensors, c: dict,
         blocks: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the micro-batch's loss, the loads ``[L_moe, E]``): as
    ``plain_deepseek_v3.loss``."""
    ids, labels = batch["input_ids"].long(), batch["labels"].long()
    count = (labels != -100).sum().clamp_min(1)
    total, loads = 0.0, 0.0
    for row in range(ids.shape[0]):
        h, balance, row_loads = hidden(P, biases, ids[row], c, blocks)
        nll = F.cross_entropy(h @ P["lm_head.weight"].t(), labels[row], ignore_index=-100,
                              reduction="sum")
        total = total + nll / count + c["aux_loss_alpha"] * balance / ids.shape[0]
        loads = loads + row_loads
    return total, loads


bias_update = ds.bias_update
weight_decay_mask = ds.weight_decay_mask


def draw(spec: list, seed: int, device) -> Tensors:
    """``{name: float32 tensor on device}`` for every leaf of ``spec``:
    ``init.draw`` for its kinds, then from a second stream of the seed the
    convolutions ``U(-1/2, 1/2)`` (``1 / sqrt(taps)``), ``A_log = log U(1,
    16)`` and ``dt_bias`` the inverse softplus of ``exp U(log 1e-3, log
    1e-1)``."""
    out = init.draw([e for e in spec if e[2] not in KINDS], seed, device)
    g = init.generator(seed, device, offset=1)
    for name, shape, kind, _scale in spec:
        if kind not in KINDS:
            continue
        u = torch.rand(shape, generator=g, device=device)
        if kind == "conv":
            out[name] = (u * 2 - 1) / math.sqrt(shape[-1])
        elif kind == "a_log":
            out[name] = torch.log(1 + 15 * u)
        else:
            dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
            out[name] = dt + torch.log(-torch.expm1(-dt))
    return {name: out[name] for name, *_ in spec}
