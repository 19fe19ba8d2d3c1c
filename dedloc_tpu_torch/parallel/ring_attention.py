"""Long-context attention without the kernel: blockwise (memory-efficient)
attention and its dense reference, in plain PyTorch.

Port of ``dedloc_tpu/parallel/ring_attention.py``. ``blockwise_attention``
is the online softmax over KV blocks that the JAX package runs under
``lax.scan`` (no Pallas kernel, so no CUDA kernel here either): it never
holds more than one ``[B, H, S, block]`` score block at a time.
``dense_attention`` is the O(S^2) reference. Layout as the JAX package:
``[B, S, H, D]`` in and out, an additive ``[B, S_kv]`` key bias. Scores,
the running max and sum and the accumulator are fp32; probabilities are
rounded to v's dtype before ``p . v``.

``ring_attention`` is the sequence-parallel variant over a slice mesh's
``seq`` axis: KV shards rotate around the ring of ranks.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from dedloc_tpu_torch.utils.device import divide

NEG_INF = -1e30


def _qk(q, k) -> torch.Tensor:
    """``q . k`` as ``[B, H, Sq, Sk]`` fp32 (bf16 products are exact in fp32)."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())


def _add_bias(s, bias):
    return s if bias is None else s + bias[:, None, None, :].float()


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``p . v`` with p rounded to v's dtype, accumulated in fp32."""
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())


def _block_update(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, H, D]
    v: torch.Tensor,  # [B, Skv, H, D]
    bias: Optional[torch.Tensor],  # [B, Skv] additive
    acc: torch.Tensor,  # [B, Sq, H, D] fp32 running numerator
    row_max: torch.Tensor,  # [B, Sq, H] fp32 running max
    row_sum: torch.Tensor,  # [B, Sq, H] fp32 running denominator
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One online-softmax accumulation step against a KV block."""
    s = _add_bias(_qk(q, k) * (1.0 / math.sqrt(q.shape[-1])), bias)
    new_max = torch.maximum(row_max, s.amax(-1).transpose(1, 2))
    correction = torch.exp(row_max - new_max)
    p = torch.exp(s - new_max.transpose(1, 2)[..., None])  # [B, H, Sq, K]
    acc = acc * correction[..., None] + _pv(p, v)
    row_sum = row_sum * correction + p.sum(-1).transpose(1, 2)
    return acc, new_max, row_sum


def blockwise_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,  # [B, S] additive kv-position bias
    block_size: int = 512,
) -> torch.Tensor:
    """Exact attention with KV processed in blocks (the JAX scan's blocks:
    ``max(1, S // block_size)`` of them, equal in size)."""
    b, s, h, d = q.shape
    num_blocks = max(1, s // block_size)
    if s % num_blocks:
        raise ValueError(f"seq length {s} must divide into {num_blocks} "
                         f"blocks (block_size {block_size})")
    bs = s // num_blocks
    acc = torch.zeros((b, s, h, d), device=q.device, dtype=torch.float32)
    row_max = torch.full((b, s, h), NEG_INF, device=q.device, dtype=torch.float32)
    row_sum = torch.zeros((b, s, h), device=q.device, dtype=torch.float32)
    for i in range(num_blocks):
        blk = slice(i * bs, (i + 1) * bs)
        acc, row_max, row_sum = _block_update(
            q, k[:, blk], v[:, blk], None if bias is None else bias[:, blk],
            acc, row_max, row_sum)
    return (acc / row_sum[..., None]).to(q.dtype)


def dense_attention(q, k, v, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference O(S^2) attention for testing equivalence."""
    s = _add_bias(divide(_qk(q, k), math.sqrt(q.shape[-1])), bias)
    return _pv(torch.softmax(s, dim=-1), v).to(q.dtype)


def ring_attention(
    q: torch.Tensor,  # [B, S/n, H, D]: this rank's queries
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,  # [B, S/n] this rank's key bias
    *,
    mesh,
    axis: str = "seq",
) -> torch.Tensor:
    """Sequence-parallel exact attention over the ring of ``axis``: each
    rank holds S/n positions of q, k, v and the key bias, accumulates the
    online softmax of its queries against its own KV shard, passes the
    shard to the next rank (``ppermute``) and repeats, n blocks in all.
    Never more than one ``[B, H, S/n, S/n]`` score block at a time; the
    gradient of each hop is the reverse hop. Plain PyTorch: the JAX ring
    reaches no kernel either."""
    from dedloc_tpu_torch.parallel.mesh import ppermute

    n = mesh.shape[axis]
    b, s_l, h, d = q.shape
    acc = torch.zeros((b, s_l, h, d), device=q.device, dtype=torch.float32)
    row_max = torch.full((b, s_l, h), NEG_INF, device=q.device, dtype=torch.float32)
    row_sum = torch.zeros((b, s_l, h), device=q.device, dtype=torch.float32)
    perm = [(i, (i + 1) % n) for i in range(n)]
    for i in range(n):
        acc, row_max, row_sum = _block_update(q, k, v, bias, acc, row_max, row_sum)
        if i < n - 1:  # the last block needs no further hop
            k, v = ppermute(k, mesh, axis, perm), ppermute(v, mesh, axis, perm)
            if bias is not None:
                bias = ppermute(bias, mesh, axis, perm)
    return (acc / row_sum[..., None]).to(q.dtype)
