"""Analytic model FLOPs of one token of a Kimi Linear causal LM on one
expert-parallel rank: a frozen copy of the port's ``models/kimi_linear.py``
``flops_per_token``, over the configuration's keys as the driver gives them
(DeepSeek-V3's names plus ``kda_layers``, ``kda_heads``, ``kda_head_dim``,
``short_conv_kernel_size``).

    6 x (the parameters a token touches)
      + 3 x (the MLA layers' causal scores + the KDA chunk's forward products)

The parameters a token touches: every projection and convolution of the KDA
mixers (q, k, v, o: ``4 H W``; the decay and output-gate pairs ``2 (H d +
d W)``; the write strength ``H heads``; the convolutions ``3 W taps``) and
of the MLA mixers, the dense layers, the router, the shared experts, the
held experts' share ``k n / E`` of its pairs, and the head. The causal
scores: ``heads (d_qk + d_v)`` a key, ``(S + 1) / 2`` keys a query on
average. The chunk's forward: per head and token ``2 (3 C d_k + 2 C d_v +
3 d_k d_v)`` at ``C`` = 16 (``counts/kda.py`` ``forward_macs``). Remat's
recompute is not counted.
"""
from __future__ import annotations

from portbench.counts.kda import forward_macs

CHUNK = 16  # the port's KDA chunk


def flops_per_token(c: dict, seq: int) -> float:
    h, nh = c["hidden_size"], c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    held = c.get("experts_held") or c["n_routed_experts"]
    layers, first = c["num_hidden_layers"], c["first_k_dense_replace"]
    n_kda = sum(1 for i in range(layers) if i + 1 in c["kda_layers"])
    n_mla = layers - n_kda
    mla = (h * nh * qk + h * (c["kv_lora_rank"] + c["qk_rope_head_dim"])
           + c["kv_lora_rank"] * nh * (c["qk_nope_head_dim"] + c["v_head_dim"])
           + nh * c["v_head_dim"] * h)
    d, heads = c["kda_head_dim"], c["kda_heads"]
    w = heads * d
    kda = 4 * h * w + 2 * (h * d + d * w) + h * heads + 3 * w * c["short_conv_kernel_size"]
    expert = 3 * h * c["moe_intermediate_size"]
    moe = (c["n_routed_experts"] * h + expert * c["n_shared_experts"]
           + expert * c["num_experts_per_tok"] * held / c["n_routed_experts"])
    dense = 3 * h * c["intermediate_size"]
    params = n_mla * mla + n_kda * kda + first * dense + (layers - first) * moe + c["vocab_size"] * h
    scores = n_mla * nh * (qk + c["v_head_dim"]) * (seq + 1)
    chunk = n_kda * heads * 2 * forward_macs(d, d, CHUNK)
    return 6.0 * params + 3.0 * (scores + chunk)
