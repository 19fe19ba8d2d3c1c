"""Analytic model FLOPs of one token of a DeepSeek-V3 causal LM on one
expert-parallel rank: a frozen copy of the port's ``models/deepseek_v3.py``
``flops_per_token``, over the configuration's keys.

6 x the parameters a token touches (every attention projection, the dense
layers, the router, the shared experts, the held experts' share ``k * n /
E`` of its pairs, the head) plus 3 x the causal attention forward, whose
queries see ``(S + 1) / 2`` keys on average. Remat's recompute is not
counted.
"""
from __future__ import annotations


def flops_per_token(c: dict, seq: int) -> float:
    h, nh = c["hidden_size"], c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    held = c.get("experts_held") or c["n_routed_experts"]
    attn = (h * nh * qk + h * (c["kv_lora_rank"] + c["qk_rope_head_dim"])
            + c["kv_lora_rank"] * nh * (c["qk_nope_head_dim"] + c["v_head_dim"])
            + nh * c["v_head_dim"] * h)
    expert = 3 * h * c["moe_intermediate_size"]
    moe = (c["n_routed_experts"] * h + expert * c["n_shared_experts"]
           + expert * c["num_experts_per_tok"] * held / c["n_routed_experts"])
    dense = 3 * h * c["intermediate_size"]
    layers, first = c["num_hidden_layers"], c["first_k_dense_replace"]
    params = layers * attn + first * dense + (layers - first) * moe + c["vocab_size"] * h
    scores = layers * nh * (qk + c["v_head_dim"]) * (seq + 1)
    return 6.0 * params + 3.0 * scores
