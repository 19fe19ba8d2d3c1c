"""Kimi Linear causal language model (Kimi-Linear-48B-A3B), one
expert-parallel rank's share, for the trainer's normal path.

Kimi Linear (arXiv 2510.26692) is DeepSeek-V3's decoder with most token
mixers replaced by Kimi Delta Attention (KDA), a gated delta rule with a
per-channel decay. Each of ``num_hidden_layers`` pre-RMSNorm layers mixes
tokens by

- KDA, in the layers of ``kda_layers`` (1-based, as the published config
  writes them), ``kda_heads`` heads of ``kda_head_dim``: for normed ``x``,
  ``q, k, v = SiLU(ShortConv(W_{q,k,v} x))`` (a causal depthwise
  convolution over time, ``short_conv_kernel_size`` taps, no bias), ``q``
  and ``k`` L2-normalised per head, the decay ``g = -exp(A_log[h]) ·
  softplus(W_fb W_fa x + dt_bias)`` per channel, the write strength ``β =
  sigmoid(W_b x)`` per head, the state update of ``ops/kda.py`` with
  ``scale = d_k^-1/2``, then ``o = RMSNorm(o) ⊙ sigmoid(W_gb W_ga x)`` (per
  head) and ``W_o``;
- or else DeepSeek-V3's latent attention without a rotary embedding
  (``mla_use_nope``: ``models/deepseek_v3.py`` ``Attention``);

then the first ``first_k_dense_replace`` layers' dense SwiGLU or the
DeepSeek-V3 expert layer (sigmoid top-k, normalised and scaled gates, a
selection-only correction bias, shared experts), a final RMSNorm, an untied
head and next-token cross-entropy plus the sequence-wise balance loss: all
of it ``models/deepseek_v3.py``'s, imported.

Numerics: fp32 parameters, residual stream, RMSNorm statistics, the
convolutions, the L2 norms, ``g``, ``β``, the gated RMSNorm and the loss;
on the card the projections take bf16 inputs with fp32 accumulation and
the KDA chunk kernels take q, k, v in bf16 (on the CPU everything is fp32
and the chunk op is its plain mirror). While gradients are taken each
layer is a checkpoint recomputed in the backward (flash's out and lse
kept, as in DeepSeek-V3; the KDA chunk states are recomputed with the
layer).

Regions (``telemetry/steps.py``): a KDA layer's mixer is ``kda`` with
``proj``, ``conv``, ``gate``, ``chunk`` and ``out`` (the gated norm and
``W_o``); an MLA layer's stays ``attention``. Each KDA layer hands the
largest Frobenius norm of a head's final state over (``kda_state_norm``
in the loss's metrics, one value a KDA layer, no gradient).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dedloc_tpu_torch.models import deepseek_v3 as ds
from dedloc_tpu_torch.models.deepseek_v3 import (
    Attention, DeepseekV3Config, DeepseekV3ForCausalLM, Linear, MoE, RMSNorm, SwiGLU,
    _linear, compute_dtype, rms_norm)
from dedloc_tpu_torch.ops.kda import kda_chunk
from dedloc_tpu_torch.telemetry.steps import region

FAMILY = ("kimi-linear-48b-a3b", "kimi-linear-tiny")
KDA_LAYERS = (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23, 25, 26)


@dataclasses.dataclass(frozen=True)
class KimiLinearConfig(DeepseekV3Config):
    """The published config under DeepSeek-V3's field names
    (``num_experts`` -> ``n_routed_experts``, ``num_experts_per_token``
    -> ``num_experts_per_tok``, ``num_shared_experts`` ->
    ``n_shared_experts``, ``model_max_length`` ->
    ``max_position_embeddings``) plus ``linear_attn_config``'s keys."""

    vocab_size: int = 163840
    hidden_size: int = 2304
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    num_hidden_layers: int = 27
    num_attention_heads: int = 32
    n_routed_experts: int = 256
    num_experts_per_tok: int = 8
    n_shared_experts: int = 1
    rope_theta: float = 10000.0
    max_position_embeddings: int = 1048576
    mla_use_nope: bool = True
    kda_layers: Tuple[int, ...] = KDA_LAYERS
    kda_heads: int = 32
    kda_head_dim: int = 128
    short_conv_kernel_size: int = 4
    l2_norm_eps: float = 1e-6  # assumed: FLA's l2norm

    def is_kda(self, layer: int) -> bool:
        """Whether 0-based ``layer`` mixes tokens by KDA."""
        return layer + 1 in self.kda_layers

    @property
    def kda_width(self) -> int:
        return self.kda_heads * self.kda_head_dim

    @staticmethod
    def named(model_size: str, **overrides) -> "KimiLinearConfig":
        """``kimi-linear-48b-a3b`` (the published config) or its test twin
        ``kimi-linear-tiny``: a KDA layer with the dense FFN, a KDA layer
        and an MLA layer with experts (every layer kind), tiny widths."""
        if model_size == "kimi-linear-48b-a3b":
            return KimiLinearConfig(**overrides)
        if model_size == "kimi-linear-tiny":
            base = dict(vocab_size=256, hidden_size=32, intermediate_size=48,
                        moe_intermediate_size=16, num_hidden_layers=3,
                        num_attention_heads=2, kv_lora_rank=16, qk_nope_head_dim=8,
                        qk_rope_head_dim=8, v_head_dim=8, n_routed_experts=16,
                        num_experts_per_tok=8, n_shared_experts=1,
                        max_position_embeddings=64, kda_layers=(1, 2), kda_heads=2,
                        kda_head_dim=16)
            base.update(overrides)
            return KimiLinearConfig(**base)
        raise ValueError(f"unknown model_size {model_size!r} (expected one of {FAMILY})")


def short_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """A causal depthwise convolution over time of ``x [B, S, C]`` (fp32)
    by ``weight [C, W]`` (``nn.Conv1d(C, C, W, groups=C, padding=W - 1)``'s
    kernel ``[C, 1, W]`` without its middle axis, cut to the first S
    outputs): ``y_t = Σ_j w_j x_{t - W + 1 + j}``."""
    taps = weight.shape[-1]
    s = x.shape[1]
    padded = F.pad(x, (0, 0, taps - 1, 0))
    w = weight.float()
    y = padded[:, 0:s] * w[:, 0]
    for j in range(1, taps):
        y = y + padded[:, j:j + s] * w[:, j]
    return y


def l2_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + eps)


class ShortConv(nn.Module):
    def __init__(self, channels: int, taps: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, taps))


class KimiDeltaAttention(nn.Module):
    def __init__(self, cfg: KimiLinearConfig):
        super().__init__()
        h, nh, d, width = cfg.hidden_size, cfg.kda_heads, cfg.kda_head_dim, cfg.kda_width
        self.q_proj = Linear(h, width)
        self.k_proj = Linear(h, width)
        self.v_proj = Linear(h, width)
        self.q_conv1d = ShortConv(width, cfg.short_conv_kernel_size)
        self.k_conv1d = ShortConv(width, cfg.short_conv_kernel_size)
        self.v_conv1d = ShortConv(width, cfg.short_conv_kernel_size)
        self.A_log = nn.Parameter(torch.empty(nh))
        self.f_a_proj = Linear(h, d)
        self.f_b_proj = Linear(d, width)
        self.dt_bias = nn.Parameter(torch.empty(width))
        self.b_proj = Linear(h, nh)
        self.g_a_proj = Linear(h, d)
        self.g_b_proj = Linear(d, width)
        self.o_norm = RMSNorm(d)
        self.o_proj = Linear(width, h)

    def forward(self, x: torch.Tensor, cfg: KimiLinearConfig):
        """(the mixer's output [B, S, H] fp32, the largest head's final-state
        norm) for the normed ``x [B, S, H]``."""
        b, s, _ = x.shape
        nh, d, dt = cfg.kda_heads, cfg.kda_head_dim, compute_dtype(x)
        with region("proj"):
            q, k, v = (_linear(x, p.weight, dt) for p in (self.q_proj, self.k_proj,
                                                            self.v_proj))
        with region("conv"):
            q, k, v = (F.silu(short_conv(y.float(), c.weight)).view(b, s, nh, d)
                       for y, c in ((q, self.q_conv1d), (k, self.k_conv1d),
                                    (v, self.v_conv1d)))
            q, k = l2_norm(q, cfg.l2_norm_eps), l2_norm(k, cfg.l2_norm_eps)
        with region("gate"):
            f = _linear(_linear(x, self.f_a_proj.weight, dt), self.f_b_proj.weight, dt)
            f = f.float().view(b, s, nh, d) + self.dt_bias.float().view(nh, d)
            g = -self.A_log.float().exp()[:, None] * F.softplus(f)
            beta = torch.sigmoid(_linear(x, self.b_proj.weight, dt).float())
        with region("chunk"):
            o, norms = kda_chunk(q.to(dt), k.to(dt), v.to(dt), g, beta.contiguous(),
                                 1.0 / math.sqrt(d))
        with region("out"):
            gate = _linear(_linear(x, self.g_a_proj.weight, dt), self.g_b_proj.weight, dt)
            o = rms_norm(o, self.o_norm.weight, cfg.rms_norm_eps) * torch.sigmoid(
                gate.float().view(b, s, nh, d))
            out = _linear(o.reshape(b, s, nh * d), self.o_proj.weight, dt).float()
        return out, norms.max()


class DecoderLayer(nn.Module):
    """DeepSeek-V3's layer with KDA in place of latent attention where
    ``cfg.is_kda``; its parameter names are DeepSeek-V3's (the mixer is
    ``self_attn`` either way)."""

    def __init__(self, cfg: KimiLinearConfig, layer: int):
        super().__init__()
        self.kda = cfg.is_kda(layer)
        self.input_layernorm = RMSNorm(cfg.hidden_size)
        self.self_attn = KimiDeltaAttention(cfg) if self.kda else Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size)
        dense = layer < cfg.first_k_dense_replace
        self.mlp = SwiGLU(cfg.hidden_size, cfg.intermediate_size) if dense else MoE(cfg)

    def forward(self, x: torch.Tensor, cos, sin, cfg: KimiLinearConfig):
        """(x', balance, loads, the KDA state norm): ``models/deepseek_v3.py``
        ``DecoderLayer.forward``'s places; an MLA layer gives None for the
        last."""
        with region("norm"):
            h = rms_norm(x, self.input_layernorm.weight, cfg.rms_norm_eps)
        norm = None
        if self.kda:
            with region("kda"):
                y, norm = self.self_attn(h, cfg)
        else:
            with region("attention"):
                y = self.self_attn(h, cfg, cos, sin)
        x = x + y
        with region("norm"):
            h = rms_norm(x, self.post_attention_layernorm.weight, cfg.rms_norm_eps)
        if isinstance(self.mlp, MoE):
            with region("moe"):
                y, balance, loads = self.mlp(h, cfg)
        else:
            with region("ffn"):
                y = self.mlp(h)
            balance = loads = None
        return x + y, balance, loads, norm


class KimiLinearForCausalLM(DeepseekV3ForCausalLM):
    """``DeepseekV3ForCausalLM`` (trunk, loss, bias update) over Kimi
    Linear's layers."""

    def __init__(self, cfg: KimiLinearConfig):
        super().__init__(cfg, layer=DecoderLayer)

    def forward(self, input_ids: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """DeepSeek-V3's (loss, metrics), and ``kda_state_norm`` ``[L_kda]``:
        each KDA layer's largest final-state norm (on the device)."""
        h, balances, loads, norms = self._trunk(input_ids)
        loss, metrics = self._loss(h, balances, loads, labels)
        metrics["kda_state_norm"] = torch.stack(norms)
        return loss, metrics


Config, CausalLM = KimiLinearConfig, KimiLinearForCausalLM  # the family's builders


def init_weights(model: KimiLinearForCausalLM, generator: torch.Generator) -> None:
    """``models/deepseek_v3.py`` ``init_weights`` (N(0, 0.02^2) matrices and
    embeddings, RMSNorm scales 1, correction biases 0), then KDA's own
    leaves: the convolutions ``U(-1/2, 1/2)`` (``nn.Conv1d``'s default at 4
    taps), ``A_log = log U(1, 16)`` and ``dt_bias`` the inverse softplus of
    ``exp U(log 1e-3, log 1e-1)``."""
    ds.init_weights(model, generator)
    dev = generator.device
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("conv1d.weight"):
                bound = 1.0 / math.sqrt(p.shape[-1])
                p.copy_((torch.rand(p.shape, generator=generator, device=dev) * 2 - 1)
                        * bound)
            elif name.endswith("A_log"):
                p.copy_(torch.log(1 + 15 * torch.rand(p.shape, generator=generator,
                                                      device=dev)))
            elif name.endswith("dt_bias"):
                p.copy_(inverse_softplus_dt(torch.rand(p.shape, generator=generator,
                                                       device=dev)))


def inverse_softplus_dt(u: torch.Tensor) -> torch.Tensor:
    """``dt_bias`` from uniform draws ``u``: ``dt = exp(log 1e-3 + u (log 1e-1 -
    log 1e-3))``, then ``dt + log(-expm1(-dt))`` (softplus's inverse)."""
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return dt + torch.log(-torch.expm1(-dt))


def flops_per_token(cfg: KimiLinearConfig, seq: int) -> float:
    """Model FLOPs of one token's forward and backward on this rank: 6 x the
    parameters it touches (every projection of both mixers, the dense
    layers, the router, the shared experts, the held experts' share ``k n
    / E`` of its pairs, the head) plus 3 x each mixer's forward: the MLA
    layers' causal scores (``(S + 1) / 2`` keys a query on average) and
    the KDA chunk's products (``chunk_flops``). Remat's recompute is not
    counted."""
    h, nh = cfg.hidden_size, cfg.num_attention_heads
    layers = range(cfg.num_hidden_layers)
    n_kda = sum(cfg.is_kda(i) for i in layers)
    n_mla = cfg.num_hidden_layers - n_kda
    mla = (h * nh * cfg.qk_head_dim + h * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
           + cfg.kv_lora_rank * nh * (cfg.qk_nope_head_dim + cfg.v_head_dim)
           + nh * cfg.v_head_dim * h)
    d, w = cfg.kda_head_dim, cfg.kda_width
    kda = (4 * h * w + 2 * (h * d + d * w) + h * cfg.kda_heads
           + 3 * w * cfg.short_conv_kernel_size)
    expert = 3 * h * cfg.moe_intermediate_size
    moe = (cfg.n_routed_experts * h + expert * cfg.n_shared_experts
           + expert * cfg.num_experts_per_tok * cfg.held / cfg.n_routed_experts)
    dense = 3 * h * cfg.intermediate_size
    params = (n_mla * mla + n_kda * kda + cfg.first_k_dense_replace * dense
              + cfg.moe_layers * moe + cfg.vocab_size * h)
    scores = n_mla * nh * (cfg.qk_head_dim + cfg.v_head_dim) * (seq + 1)
    return 6.0 * params + 3.0 * (scores + n_kda * cfg.kda_heads * chunk_flops(d, d))


def chunk_flops(dk: int, dv: int, chunk: int = 16) -> float:
    """The chunked delta rule's forward operations a token and head at
    chunk ``C``: ``A`` and ``M`` (``C d_k`` each), ``W`` (``C d_k``), ``Ũ``
    (``C d_v``), ``W S``, ``(Q ⊙ e^G) S``, ``K_endᵀ U`` (``d_k d_v`` each)
    and ``M U`` (``C d_v``), 2 operations a product."""
    return 2.0 * (3 * chunk * dk + 2 * chunk * dv + 3 * dk * dv)
