"""DeepSeek-V3 causal LM (Moonlight-16B-A3B) as plain PyTorch, in float32.

The plain reference of ``models/deepseek_v3.py``, written from the papers
(DeepSeek-V2 arXiv 2405.04434 §2.1, DeepSeek-V3 arXiv 2412.19437 §2.1)
and the published configuration: pre-RMSNorm layers of latent attention
with decoupled RoPE, a dense SwiGLU first layer, then sigmoid top-k expert
layers with a selection-only correction bias, normalised and scaled gates
and shared experts; a final RMSNorm, an untied head, next-token
cross-entropy plus the sequence-wise balance loss; after each optimizer
step the bias update ``b += speed * sign(mean load - load)``.

No kernel of the port, no mixed precision, no grouping and no remat: every
operation runs in the dtype of the tensors it is given (float32 with TF32
off for the reference), the causal softmax is exact, and each held expert
takes its tokens by index one expert at a time. Departures from the
published model, shared with the program:

- RoPE in the rotate-half layout; Hugging Face's code rotates interleaved
  pairs, a fixed permutation of the rotary columns of ``q_proj`` and
  ``kv_a_proj_with_mqa``;
- one expert-parallel rank's share: the experts ``[rank * n, rank * n +
  n)`` of every expert layer compute their part of the output, the others
  are left out (no code stands in for the other ranks); the router routes
  over all of them;
- the balance loss counts each expert's routed selections (top-k of the
  biased scores) as its load;
- no mask between the documents of a packed row.

``blocks`` only changes how much is held at once, not the mathematics:
with it, each layer is recomputed in the backward
(``torch.utils.checkpoint``), attention is taken ``heads`` heads and
``rows`` queries at a time (each block recomputed too) and the loss a
sequence at a time.

Parameter names are the program's; ``spec`` lists them with their shapes.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Tensors = Dict[str, torch.Tensor]
LAYER = "model.layers.{}."


def held(c: dict) -> int:
    return c.get("experts_held") or c["n_routed_experts"]


def moe_layers(c: dict) -> List[int]:
    return list(range(c["first_k_dense_replace"], c["num_hidden_layers"]))


def spec(c: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, init kind, scale) of every parameter: N(0, std^2)
    matrices, expert stacks and embeddings, RMSNorm scales 1."""
    h, nh, std = c["hidden_size"], c["num_attention_heads"], c["initializer_range"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    f, n = c["moe_intermediate_size"], held(c)
    out = [("model.embed_tokens.weight", (c["vocab_size"], h), "normal", std)]

    def mat(name, n_in, n_out):
        out.append((name + ".weight", (n_out, n_in), "normal", std))

    def norm(name, size):
        out.append((name + ".weight", (size,), "ones", 0.0))

    def swiglu(name, width):
        mat(name + ".gate_proj", h, width)
        mat(name + ".up_proj", h, width)
        mat(name + ".down_proj", width, h)

    for i in range(c["num_hidden_layers"]):
        p = LAYER.format(i)
        norm(p + "input_layernorm", h)
        mat(p + "self_attn.q_proj", h, nh * qk)
        mat(p + "self_attn.kv_a_proj_with_mqa", h, c["kv_lora_rank"] + c["qk_rope_head_dim"])
        norm(p + "self_attn.kv_a_layernorm", c["kv_lora_rank"])
        mat(p + "self_attn.kv_b_proj", c["kv_lora_rank"],
            nh * (c["qk_nope_head_dim"] + c["v_head_dim"]))
        mat(p + "self_attn.o_proj", nh * c["v_head_dim"], h)
        norm(p + "post_attention_layernorm", h)
        if i < c["first_k_dense_replace"]:
            swiglu(p + "mlp", c["intermediate_size"])
        else:
            mat(p + "mlp.gate", h, c["n_routed_experts"])
            out.append((p + "mlp.experts.gate_up_proj", (n, h, 2 * f), "normal", std))
            out.append((p + "mlp.experts.down_proj", (n, f, h), "normal", std))
            swiglu(p + "mlp.shared_experts", f * c["n_shared_experts"])
    norm("model.final_layernorm", h)
    mat("lm_head", h, c["vocab_size"])
    return out


def bias_name(layer: int) -> str:
    return LAYER.format(layer) + "mlp.gate.e_score_correction_bias"


def weight_decay_mask(names) -> Dict[str, bool]:
    """Decoupled weight decay skips the RMSNorm scales."""
    return {n: "layernorm" not in n for n in names}


def rms_norm(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope(x, theta):
    """RoPE (rotate-half) on ``x [S, heads, dim]`` at positions 0 .. S-1."""
    s, _h, d = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device, dtype=x.dtype) / d))
    ang = torch.arange(s, device=x.device, dtype=x.dtype)[:, None] * inv[None]
    ang = torch.cat([ang, ang], -1)[:, None]
    rotated = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * ang.cos() + rotated * ang.sin()


def _attention_block(q, k, v, first_row):
    """Causal softmax attention of the queries ``q [heads, r, d]`` at rows
    ``first_row ..`` over every key."""
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    rows = torch.arange(q.shape[1], device=q.device)[:, None] + first_row
    later = torch.arange(k.shape[1], device=q.device)[None] > rows
    return torch.softmax(s.masked_fill(later, float("-inf")), -1) @ v


def attention(q, k, v, blocks: bool, heads: int = 4, rows: int = 2048):
    """``[H, S, d]`` inputs; with ``blocks`` a few heads and rows at a time."""
    if not blocks:
        return _attention_block(q, k, v, 0)
    out = []
    for h0 in range(0, q.shape[0], heads):
        hs = slice(h0, h0 + heads)
        out.append(torch.cat([
            checkpoint(_attention_block, q[hs, r:r + rows], k[hs], v[hs], r,
                       use_reentrant=False)
            for r in range(0, q.shape[1], rows)], 1))
    return torch.cat(out, 0)


def _swiglu(P, name, x):
    g = x @ P[name + ".gate_proj.weight"].t()
    u = x @ P[name + ".up_proj.weight"].t()
    return (F.silu(g) * u) @ P[name + ".down_proj.weight"].t()


def _mla(P, p, h, c, blocks):
    """Latent attention of one sequence ``h [S, H]``."""
    s = h.shape[0]
    nh, nope, rdim, dv = (c["num_attention_heads"], c["qk_nope_head_dim"],
                          c["qk_rope_head_dim"], c["v_head_dim"])
    q = (h @ P[p + "self_attn.q_proj.weight"].t()).view(s, nh, nope + rdim)
    kv_a = h @ P[p + "self_attn.kv_a_proj_with_mqa.weight"].t()
    c_kv = rms_norm(kv_a[:, :c["kv_lora_rank"]], P[p + "self_attn.kv_a_layernorm.weight"],
                    c["rms_norm_eps"])
    k_pe = rope(kv_a[:, c["kv_lora_rank"]:].view(s, 1, rdim), c["rope_theta"])
    kv = (c_kv @ P[p + "self_attn.kv_b_proj.weight"].t()).view(s, nh, nope + dv)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], c["rope_theta"])], -1)
    k = torch.cat([kv[..., :nope], k_pe.expand(s, nh, rdim)], -1)
    o = attention(q.transpose(0, 1), k.transpose(0, 1), kv[..., nope:].transpose(0, 1),
                  blocks)
    return o.transpose(0, 1).reshape(s, nh * dv) @ P[p + "self_attn.o_proj.weight"].t()


def _moe(P, p, h, bias, c):
    """One sequence's expert layer: (output, balance loss, loads [E])."""
    s, e, k = h.shape[0], c["n_routed_experts"], c["num_experts_per_tok"]
    scores = torch.sigmoid(h @ P[p + "mlp.gate.weight"].t())
    top = torch.topk(scores.detach() + bias, k, dim=-1).indices  # [S, k]
    picked = scores.gather(-1, top)
    gates = picked / picked.sum(-1, keepdim=True) * c["routed_scaling_factor"]
    chosen = torch.zeros(s, e, device=h.device, dtype=h.dtype).scatter(1, top, 1.0)
    f = chosen.sum(0) * e / (k * s)
    balance = (f * (scores / scores.sum(-1, keepdim=True)).mean(0)).sum()
    n, first = held(c), c.get("expert_rank", 0) * held(c)
    fw = c["moe_intermediate_size"]
    y = torch.zeros_like(h)
    for j in range(n):
        token, slot = torch.nonzero(top == first + j, as_tuple=True)
        x = h[token]
        gu = x @ P[p + "mlp.experts.gate_up_proj"][j]
        out = (F.silu(gu[:, :fw]) * gu[:, fw:]) @ P[p + "mlp.experts.down_proj"][j]
        y = y.index_add(0, token, out * gates[token, slot][:, None])
    y = y + _swiglu(P, p + "mlp.shared_experts", h)
    return y, balance, chosen.sum(0).detach()


def _layer(P, i, x, bias, c, blocks):
    p = LAYER.format(i)
    eps = c["rms_norm_eps"]
    x = x + _mla(P, p, rms_norm(x, P[p + "input_layernorm.weight"], eps), c, blocks)
    h = rms_norm(x, P[p + "post_attention_layernorm.weight"], eps)
    if bias is None:
        return x + _swiglu(P, p + "mlp", h), x.new_zeros(()), x.new_zeros(0)
    y, balance, loads = _moe(P, p, h, bias, c)
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
            x, bal, load = checkpoint(_layer, P, i, x, bias, c, blocks, use_reentrant=False)
        else:
            x, bal, load = _layer(P, i, x, bias, c, blocks)
        if bias is not None:
            balance = balance + bal
            loads.append(load)
    h = rms_norm(x, P["model.final_layernorm.weight"], c["rms_norm_eps"])
    return h, balance, torch.stack(loads)


def logits(P: Tensors, biases: Dict[int, torch.Tensor], ids: torch.Tensor, c: dict
           ) -> torch.Tensor:
    """The next-token logits ``[B, S, V]``."""
    return torch.stack([hidden(P, biases, row, c)[0] @ P["lm_head.weight"].t()
                        for row in ids])


def loss(P: Tensors, biases: Dict[int, torch.Tensor], batch: Tensors, c: dict,
         blocks: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the micro-batch's loss, the loads ``[L_moe, E]`` its routing gave):
    mean next-token cross-entropy over the labelled positions (label -100:
    none) plus ``aux_loss_alpha`` times the balance loss summed over the
    expert layers and averaged over the sequences. ``biases`` maps each
    expert layer to its correction bias."""
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


def bias_update(biases: Dict[int, torch.Tensor], loads: torch.Tensor, speed: float) -> None:
    """``b += speed * sign(mean load - load)`` for each expert layer, from a
    step's loads ``[L_moe, E]`` summed over its micro-batches."""
    for bias, load in zip(biases.values(), loads):
        bias.add_(speed * torch.sign(load.mean() - load))
