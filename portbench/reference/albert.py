"""ALBERT for MLM + sentence-order pretraining, plain PyTorch.

Written from the paper (Lan et al., arXiv 1909.11942) and the
``albert-large-v2`` configuration: factorised embeddings (E -> H), one
shared post-LayerNorm block applied ``num_hidden_layers`` times,
tanh-GELU FFN, the MLM head tied to the word embeddings and evaluated at
the masked positions only, and the sentence-order head on the pooled
first token. No kernels, no mixed precision: every operation runs in the
dtype of the parameters it is given (float32 for the reference, with TF32
off). Exact attention is taken a block of queries at a time and each
block is recomputed in the backward (``torch.utils.checkpoint``), as is
each block application, so that S = 16,384 fits; neither changes the
mathematics.

Parameter names are the ones the benchmark's weights are keyed by.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BLOCK = "albert.encoder.layer.block."


def spec(c: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, init kind, scale) of every parameter: N(0, 0.02^2)
    matrices and embeddings, zero biases, LayerNorm scale 1 and bias 0."""
    h, e, i, v = (c["hidden_size"], c["embedding_size"], c["intermediate_size"],
                  c["vocab_size"])
    std = c["initializer_range"]
    out = [("mlm_bias", (v,), "zeros", 0.0)]

    def dense(name, n_in, n_out):
        out.extend([(name + ".weight", (n_out, n_in), "normal", std),
                    (name + ".bias", (n_out,), "zeros", 0.0)])

    def norm(name, n):
        out.extend([(name + ".weight", (n,), "ones", 0.0),
                    (name + ".bias", (n,), "zeros", 0.0)])

    out += [("albert.word_embeddings.weight", (v, e), "normal", std),
            ("albert.position_embeddings.weight",
             (c["max_position_embeddings"], e), "normal", std),
            ("albert.token_type_embeddings.weight", (c["type_vocab_size"], e),
             "normal", std)]
    norm("albert.embeddings_layernorm", e)
    dense("albert.embedding_projection", e, h)
    for name in ("query", "key", "value", "dense"):
        dense(BLOCK + "attention." + name, h, h)
    norm(BLOCK + "attention.layernorm", h)
    dense(BLOCK + "ffn", h, i)
    dense(BLOCK + "ffn_output", i, h)
    norm(BLOCK + "layernorm", h)
    dense("albert.pooler", h, h)
    dense("mlm_dense", h, e)
    norm("mlm_layernorm", e)
    dense("sop_classifier", h, 2)
    return out


def weight_decay_mask(names) -> Dict[str, bool]:
    """LAMB's decoupled weight decay skips biases and LayerNorm leaves."""
    return {n: not (n.endswith("bias") or "layernorm" in n) for n in names}


def _linear(P, name, x):
    return F.linear(x, P[name + ".weight"], P[name + ".bias"])


def _norm(P, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"], P[name + ".bias"], eps)


def _attention_block(q, k, v, bias):
    scores = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]) + bias
    return torch.softmax(scores, dim=-1) @ v


def attention(q, k, v, bias, max_scores: int = 2 ** 28):
    """softmax(q k^T / sqrt(d) + bias) v over [B, H, S, D], a block of
    queries at a time so that a block's scores hold at most
    ``max_scores`` elements."""
    b, h, s, _d = q.shape
    rows = max(1, min(s, max_scores // max(1, b * h * s)))
    bias = bias[:, None, None, :]
    if rows >= s:
        return _attention_block(q, k, v, bias)
    return torch.cat([checkpoint(_attention_block, q[:, :, r:r + rows], k, v, bias,
                                 use_reentrant=False)
                      for r in range(0, s, rows)], dim=2)


def _block(P, x, bias, c):
    b, s, h = x.shape
    nh = c["num_attention_heads"]
    heads = lambda t: t.view(b, s, nh, h // nh).transpose(1, 2)
    q, k, v = (heads(_linear(P, BLOCK + "attention." + n, x))
               for n in ("query", "key", "value"))
    ctx = attention(q, k, v, bias).transpose(1, 2).reshape(b, s, h)
    eps = c["layer_norm_eps"]
    x = _norm(P, BLOCK + "attention.layernorm",
              _linear(P, BLOCK + "attention.dense", ctx) + x, eps)
    ffn = F.gelu(_linear(P, BLOCK + "ffn", x), approximate="tanh")
    return _norm(P, BLOCK + "layernorm", _linear(P, BLOCK + "ffn_output", ffn) + x, eps)


def loss(P: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], c: dict
         ) -> torch.Tensor:
    """MLM (mean over the weighted masked positions) + SOP (mean over
    rows) cross-entropy of one micro-batch."""
    ids = batch["input_ids"].long()
    b, s = ids.shape
    eps = c["layer_norm_eps"]
    emb = (P["albert.word_embeddings.weight"][ids]
           + P["albert.position_embeddings.weight"][:s][None]
           + P["albert.token_type_embeddings.weight"][batch["token_type_ids"].long()])
    x = _linear(P, "albert.embedding_projection",
                _norm(P, "albert.embeddings_layernorm", emb, eps))
    dtype = x.dtype
    bias = torch.where(batch["attention_mask"] > 0, 0.0, -1e9).to(dtype)
    for _ in range(c["num_hidden_layers"]):
        x = checkpoint(_block, P, x, bias, c, use_reentrant=False)
    pooled = torch.tanh(_linear(P, "albert.pooler", x[:, 0]))
    sop_logits = _linear(P, "sop_classifier", pooled)
    pos = batch["mlm_positions"].long()
    gathered = torch.gather(x, 1, pos[..., None].expand(-1, -1, x.shape[-1]))
    m = F.gelu(_linear(P, "mlm_dense", gathered), approximate="tanh")
    m = _norm(P, "mlm_layernorm", m, eps)
    logits = m @ P["albert.word_embeddings.weight"].t() + P["mlm_bias"]
    nll = -torch.log_softmax(logits, -1).gather(
        -1, batch["mlm_label_ids"].long()[..., None])[..., 0]
    w = batch["mlm_weights"].to(dtype)
    mlm = (nll * w).sum() / w.sum().clamp_min(1.0)
    sop = -torch.log_softmax(sop_logits, -1).gather(
        -1, batch["sop_labels"].long()[:, None])[:, 0].mean()
    return mlm + sop
