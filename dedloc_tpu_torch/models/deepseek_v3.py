"""DeepSeek-V3 causal language model (Moonlight-16B-A3B), one expert-parallel
rank's share, for the trainer's normal path.

The layer equations are DeepSeek-V2/V3's (arXiv 2405.04434 §2.1, 2412.19437
§2.1) with ``q_lora_rank`` null, one routing group and no multi-token
prediction layer. Each of ``num_hidden_layers`` pre-RMSNorm layers:

- latent attention (MLA): ``q = W_q h`` gives per head ``q_nope`` and
  ``q_pe``; ``[c_kv, k_pe] = W_kv_a h``, ``c_kv = RMSNorm(c_kv)``;
  ``[k_nope, v] = W_kv_b c_kv`` per head; RoPE on ``q_pe`` and on the one
  ``k_pe`` that all heads share; a causal softmax of ``[q_nope, q_pe] .
  [k_nope, k_pe]`` scaled by ``(qk_nope + qk_rope)^-1/2`` over ``v``, then
  ``o_proj``. It runs on the flash kernels at q/k 192 and v 128 wide
  (``ops/flash_attention.py``, ``causal=True``);
- the first ``first_k_dense_replace`` layers: a dense SwiGLU FFN; the
  others: the top-k sigmoid expert layer (``parallel/moe.py``
  ``route_topk``, ``routed_experts``) plus the shared experts, one SwiGLU
  of ``n_shared_experts`` times the expert width that every token takes.

Then a final RMSNorm, an untied head and next-token cross-entropy, plus
``aux_loss_alpha`` times the sequence-wise balance loss of every expert
layer. The correction bias of each router is a buffer (no gradient):
``bias_update`` moves it after each optimizer step from the step's loads.

Expert parallelism: the layer holds ``experts_held`` of the
``n_routed_experts`` (0: all), rank ``expert_rank``'s block ``[rank * n,
rank * n + n)``, routes over all of them and computes its own experts'
part of the output; the router, attention, shared experts and dense layer
are whole on every rank. On one card the layer runs without the axis's
exchange.

Numerics: fp32 parameters, residual stream, RMSNorm statistics, softmax and
loss; on the card the matmuls take bf16 inputs with fp32 accumulation (on
the CPU, whose plain paths the tests hold to the reference, fp32); the
router's product in fp32 with TF32 refused. While gradients are taken each
layer is a selective checkpoint that keeps the flash forward's ``out`` and
``lse``.

RoPE uses the rotate-half layout. Hugging Face's DeepSeek-V3 code applies
it to interleaved pairs, a fixed permutation of the 64 rotary columns of
``q_proj`` and ``kv_a_proj_with_mqa``: a published checkpoint would load
with those rows permuted. The final norm is ``final_layernorm`` (the
published ``model.norm``), so the port's weight-decay rule leaves it out.

Regions (``telemetry/steps.py``): ``attention`` (projections, RoPE and
flash), ``norm`` (the RMSNorms) and ``moe`` with ``route``, ``dispatch``,
``experts``, ``combine`` and ``shared``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from dedloc_tpu_torch.ops import flash_attention as _flash
from dedloc_tpu_torch.parallel.moe import route_topk, routed_experts, sequence_balance
from dedloc_tpu_torch.telemetry.steps import region

FAMILY = ("moonlight-16b-a3b", "deepseek-v3-tiny")


@dataclasses.dataclass(frozen=True)
class DeepseekV3Config:
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    first_k_dense_replace: int = 1
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    routed_scaling_factor: float = 2.446
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    max_position_embeddings: int = 8192
    initializer_range: float = 0.02
    # no rotary embedding: q/k keep their 192-wide [nope | rope] layout and
    # the rope columns enter the scores as they are (Kimi Linear's MLA)
    mla_use_nope: bool = False
    # training rules the published config does not give (DeepSeek-V3,
    # arXiv 2412.19437 §2.1.2, §4.2)
    bias_update_speed: float = 1e-3
    aux_loss_alpha: float = 1e-4
    # this rank's share of an expert axis (0: every expert)
    experts_held: int = 0
    expert_rank: int = 0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def held(self) -> int:
        return self.experts_held or self.n_routed_experts

    @property
    def first_expert(self) -> int:
        return self.expert_rank * self.held

    @property
    def moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace

    @staticmethod
    def named(model_size: str, **overrides) -> "DeepseekV3Config":
        """``moonlight-16b-a3b`` (the published config) or its test twin
        ``deepseek-v3-tiny`` (every mechanism, tiny widths)."""
        if model_size == "moonlight-16b-a3b":
            return DeepseekV3Config(**overrides)
        if model_size == "deepseek-v3-tiny":
            base = dict(vocab_size=256, hidden_size=32, intermediate_size=48,
                        moe_intermediate_size=16, num_hidden_layers=3,
                        num_attention_heads=2, kv_lora_rank=16, qk_nope_head_dim=8,
                        qk_rope_head_dim=8, v_head_dim=8, n_routed_experts=8,
                        num_experts_per_tok=3, n_shared_experts=2,
                        max_position_embeddings=64)
            base.update(overrides)
            return DeepseekV3Config(**base)
        raise ValueError(f"unknown model_size {model_size!r} (expected one of {FAMILY})")


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """``weight * x / rms(x)`` with fp32 statistics, in fp32."""
    x = x.float()
    return weight.float() * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope_tables(seq: int, dim: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin ``[S, dim]`` of positions ``0 .. S-1`` (rotate-half)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=device, dtype=torch.float32) / dim))
    angles = torch.arange(seq, device=device, dtype=torch.float32)[:, None] * inv[None]
    angles = torch.cat([angles, angles], -1)
    return angles.cos(), angles.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE on ``x [B, S, heads, dim]`` in fp32."""
    x = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos[None, :, None] + rotated * sin[None, :, None]


def _linear(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), w.to(dtype))


def compute_dtype(x: torch.Tensor):
    """The matmuls' input dtype: bf16 on the card, fp32 on the CPU."""
    return torch.bfloat16 if x.is_cuda else torch.float32


class RMSNorm(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))


class Linear(nn.Module):
    """A bias-free projection ``[out, in]`` (``nn.Linear``'s layout)."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in))


class Attention(nn.Module):
    def __init__(self, cfg: DeepseekV3Config):
        super().__init__()
        h, nh = cfg.hidden_size, cfg.num_attention_heads
        self.q_proj = Linear(h, nh * cfg.qk_head_dim)
        self.kv_a_proj_with_mqa = Linear(h, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank)
        self.kv_b_proj = Linear(cfg.kv_lora_rank,
                                nh * (cfg.qk_nope_head_dim + cfg.v_head_dim))
        self.o_proj = Linear(nh * cfg.v_head_dim, h)

    def forward(self, h: torch.Tensor, cfg: DeepseekV3Config, cos, sin) -> torch.Tensor:
        b, s, _ = h.shape
        nh, dt = cfg.num_attention_heads, compute_dtype(h)
        nope, rope, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        q = _linear(h, self.q_proj.weight, dt).view(b, s, nh, nope + rope)
        kv_a = _linear(h, self.kv_a_proj_with_mqa.weight, dt)
        c_kv, k_pe = kv_a[..., :cfg.kv_lora_rank], kv_a[..., cfg.kv_lora_rank:]
        with region("norm"):
            c_kv = rms_norm(c_kv, self.kv_a_layernorm.weight, cfg.rms_norm_eps)
        kv = _linear(c_kv, self.kv_b_proj.weight, dt).view(b, s, nh, nope + dv)
        k_pe = k_pe.reshape(b, s, 1, rope)
        if not cfg.mla_use_nope:
            q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], cos, sin).to(dt)], -1)
            k_pe = apply_rope(k_pe, cos, sin)
        k_pe = k_pe.to(dt)
        k = torch.cat([kv[..., :nope], k_pe.expand(b, s, nh, rope)], -1)
        v = kv[..., nope:].contiguous()
        o = _flash.flash_attention(q, k, v, causal=True)
        return _linear(o.reshape(b, s, nh * dv), self.o_proj.weight, dt).float()


class SwiGLU(nn.Module):
    def __init__(self, h: int, f: int):
        super().__init__()
        self.gate_proj = Linear(h, f)
        self.up_proj = Linear(h, f)
        self.down_proj = Linear(f, h)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        dtype = compute_dtype(h)
        g = _linear(h, self.gate_proj.weight, dtype).float()
        u = _linear(h, self.up_proj.weight, dtype).float()
        return _linear(F.silu(g) * u, self.down_proj.weight, dtype).float()


class Router(nn.Module):
    def __init__(self, cfg: DeepseekV3Config):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts, cfg.hidden_size))
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(cfg.n_routed_experts))


class Experts(nn.Module):
    """The held experts' stacked SwiGLU weights, input-major: ``gate_up_proj
    [n, H, 2F]`` (gate columns, then up) and ``down_proj [n, F, H]``."""

    def __init__(self, cfg: DeepseekV3Config):
        super().__init__()
        n, h, f = cfg.held, cfg.hidden_size, cfg.moe_intermediate_size
        self.gate_up_proj = nn.Parameter(torch.empty(n, h, 2 * f))
        self.down_proj = nn.Parameter(torch.empty(n, f, h))


class MoE(nn.Module):
    def __init__(self, cfg: DeepseekV3Config):
        super().__init__()
        self.gate = Router(cfg)
        self.experts = Experts(cfg)
        self.shared_experts = SwiGLU(cfg.hidden_size,
                                     cfg.moe_intermediate_size * cfg.n_shared_experts)

    def forward(self, h: torch.Tensor, cfg: DeepseekV3Config):
        """(y [B, S, H] fp32, balance loss, loads [E]) for ``h [B, S, H]``."""
        b, s, d = h.shape
        x = h.reshape(b * s, d)
        with region("route"):
            r = route_topk(self.gate.weight, self.gate.e_score_correction_bias, x,
                           cfg.num_experts_per_tok, cfg.routed_scaling_factor)
            balance = sequence_balance(r, b)
        y = routed_experts(x, r, self.experts.gate_up_proj, self.experts.down_proj,
                           cfg.first_expert, compute_dtype(x))
        with region("shared"):
            y = y + self.shared_experts(x)
        return y.view(b, s, d), balance, r.loads


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, dense: bool):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size)
        self.self_attn = Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size)
        self.mlp = SwiGLU(cfg.hidden_size, cfg.intermediate_size) if dense else MoE(cfg)

    def forward(self, x: torch.Tensor, cos, sin, cfg: DeepseekV3Config):
        """(x', balance, loads, None) of one layer on the fp32 residual
        ``x``; a dense layer gives None for balance and loads. (The last
        place is a token mixer's counter: ``models/kimi_linear.py``.)"""
        with region("norm"):
            h = rms_norm(x, self.input_layernorm.weight, cfg.rms_norm_eps)
        with region("attention"):
            x = x + self.self_attn(h, cfg, cos, sin)
        with region("norm"):
            h = rms_norm(x, self.post_attention_layernorm.weight, cfg.rms_norm_eps)
        if isinstance(self.mlp, MoE):
            with region("moe"):
                y, balance, loads = self.mlp(h, cfg)
        else:
            with region("ffn"):
                y = self.mlp(h)
            balance = loads = None
        return x + y, balance, loads, None


def _keep_flash(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op is _flash.FORWARD_OP
            else CheckpointPolicy.PREFER_RECOMPUTE)


class Model(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, layer=None):
        super().__init__()
        layer = layer or (lambda c, i: DecoderLayer(c, i < c.first_k_dense_replace))
        self.embed_tokens = nn.Module()
        self.embed_tokens.weight = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size))
        self.layers = nn.ModuleList([layer(cfg, i) for i in range(cfg.num_hidden_layers)])
        self.final_layernorm = RMSNorm(cfg.hidden_size)


class DeepseekV3ForCausalLM(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, layer=None):
        super().__init__()
        self.cfg = cfg
        self.model = Model(cfg, layer)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size)

    def _trunk(self, input_ids: torch.Tensor):
        """(final-normed hidden states [B, S, H] fp32, each expert layer's
        balance loss, each one's loads [E], the token mixers' counters: the
        fourth place of each layer's output that is not None)."""
        cfg = self.cfg
        x = self.model.embed_tokens.weight[input_ids.long()].float()
        cos = sin = None
        if not cfg.mla_use_nope:
            cos, sin = rope_tables(input_ids.shape[1], cfg.qk_rope_head_dim,
                                   cfg.rope_theta, x.device)
        balances, loads, counters = [], [], []
        for layer in self.model.layers:
            if torch.is_grad_enabled():
                x, balance, load, counter = checkpoint(
                    layer, x, cos, sin, cfg, use_reentrant=False,
                    context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                 _keep_flash))
            else:
                x, balance, load, counter = layer(x, cos, sin, cfg)
            if balance is not None:
                balances.append(balance)
                loads.append(load.detach())
            if counter is not None:
                counters.append(counter.detach())
        with region("norm"):
            h = rms_norm(x, self.model.final_layernorm.weight, cfg.rms_norm_eps)
        return h, balances, loads, counters

    def logits(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The next-token logits ``[B, S, V]`` in fp32."""
        h = self._trunk(input_ids)[0]
        return _linear(h, self.lm_head.weight, compute_dtype(h)).float()

    def forward(self, input_ids: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of one packed micro-batch: ``input_ids`` and the
        next-token ``labels`` ``[B, S]`` (-100: no label)."""
        h, balances, loads, _counters = self._trunk(input_ids)
        return self._loss(h, balances, loads, labels)

    def _loss(self, h: torch.Tensor, balances, loads, labels: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) from the trunk's normed states, balance losses
        and loads."""
        cfg = self.cfg
        b, s = labels.shape
        with region("head"):
            logits = _linear(h, self.lm_head.weight, compute_dtype(h)).float()
            lm = F.cross_entropy(logits.view(b * s, -1), labels.reshape(-1).long(),
                                 ignore_index=-100)
        balance = torch.stack(balances).sum() if balances else lm.new_zeros(())
        loss = lm + cfg.aux_loss_alpha * balance
        empty = torch.zeros(0, cfg.n_routed_experts, device=h.device)
        return loss, {"loss": loss, "lm_loss": lm.detach(), "balance": balance.detach(),
                      "expert_loads": torch.stack(loads) if loads else empty}

    def correction_biases(self) -> torch.Tensor:
        """Every expert layer's correction bias, stacked ``[L_moe, E]`` (a
        copy)."""
        return torch.stack([l.mlp.gate.e_score_correction_bias for l in self.model.layers
                            if isinstance(l.mlp, MoE)])

    @torch.no_grad()
    def bias_update(self, loads: torch.Tensor) -> None:
        """Each expert layer's ``b += speed * sign(mean load - load)`` from
        ``loads [L_moe, E]``, a step's pairs summed over its micro-batches."""
        from dedloc_tpu_torch.parallel.moe import bias_update

        moe = [l.mlp.gate.e_score_correction_bias for l in self.model.layers
               if isinstance(l.mlp, MoE)]
        for bias, load in zip(moe, loads):
            bias_update(bias, load, self.cfg.bias_update_speed)


Config, CausalLM = DeepseekV3Config, DeepseekV3ForCausalLM  # the family's builders


def init_weights(model: DeepseekV3ForCausalLM, generator: torch.Generator) -> None:
    """N(0, initializer_range^2) matrices and embeddings, RMSNorm scales 1,
    correction biases 0, drawn on the generator's device."""
    std = model.cfg.initializer_range
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator, device=generator.device) * std)
        for _name, buf in model.named_buffers():
            buf.zero_()


def flops_per_token(cfg: DeepseekV3Config, seq: int) -> float:
    """Model FLOPs of one token's forward and backward on this rank: 6 x
    the parameters it touches (the held experts' share of its k pairs)
    plus 3 x the causal attention forward (the average over the sequence
    of ``(S + 1) / 2`` keys a query). Remat's recompute is not counted."""
    h, nh = cfg.hidden_size, cfg.num_attention_heads
    attn = (h * nh * cfg.qk_head_dim + h * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
            + cfg.kv_lora_rank * nh * (cfg.qk_nope_head_dim + cfg.v_head_dim)
            + nh * cfg.v_head_dim * h)
    expert = 3 * h * cfg.moe_intermediate_size
    moe = (cfg.n_routed_experts * h + expert * cfg.n_shared_experts
           + expert * cfg.num_experts_per_tok * cfg.held / cfg.n_routed_experts)
    dense = 3 * h * cfg.intermediate_size
    params = (cfg.num_hidden_layers * attn + cfg.first_k_dense_replace * dense
              + cfg.moe_layers * moe + cfg.vocab_size * h)
    scores = cfg.num_hidden_layers * nh * (cfg.qk_head_dim + cfg.v_head_dim) * (seq + 1)
    return 6.0 * params + 3.0 * scores
