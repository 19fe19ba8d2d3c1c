"""The least time of one launch of each KDA chunk kernel
(``dedloc_tpu_torch/ops/csrc/kda.cu``, wrapped by ``ops/kda.py``), counted from ``[B, S, H, d_k, d_v,
C]``: ``B`` sequences of ``S`` tokens, ``H`` heads, keys ``d_k`` and values
``d_v`` wide, chunks of ``C`` tokens (``N = ceil(S / C)`` a sequence).

Bytes: each operand read once and each output written once, in the dtype
the kernels keep it in: q, k, v, dO, dq, dk, dv and ``W`` in bf16; ``g``,
``β``, ``Ũ``/``U``, ``dU``, ``dg``, ``dβ``, each chunk's ``[C, C]`` ``M``
and each chunk's ``[d_k, d_v]`` state (``S_0``) and state gradient in fp32.
Products (2 operations a multiply-add), at the bf16 tensor-core peak:

- ``kda_fwd_intra_kernel``: ``A``, ``M``, ``W = T B_K`` (``C² d_k``
  each) and ``Ũ = T B_V`` (``C² d_v``) a chunk; reads q, k, v, g, β,
  writes W, Ũ, M;
- ``kda_fwd_state_kernel``: ``W S``, ``(Q e^G) S``, ``K_endᵀ U`` (``C d_k
  d_v`` each) and ``M U`` (``C² d_v``); reads q, k, g, W, Ũ, M, writes U,
  O and every chunk's starting state;
- ``kda_bwd_state_kernel``: ``Mᵀ dO`` (``C² d_v``), ``K_end dS``, ``(Q
  e^G)ᵀ dO``, ``Wᵀ dU`` (``C d_k d_v`` each); reads q, k, g, W, M, dO,
  writes dU and every chunk's state gradient;
- ``kda_bwd_intra_kernel``: ``Â``, ``dT``'s key part, ``dB_K``, ``R1``,
  ``R2`` and the two column sums (``C² d_k`` each), ``dM``, ``dT``'s value
  part, ``dB_V`` (``C² d_v`` each), ``dQΓ``, ``dW``, ``dK_end`` (``C d_k
  d_v`` each) and ``dA = -Tᵀ dT Tᵀ`` (``2 C³``); reads q, k, v, g, β, the
  states and their gradients, U, dU, dO, writes dq, dk, dv, dg, dβ.

The least time is the larger of the bytes over the HBM rate and the
products over the bf16 tensor-core peak (``roofline.bound_s``).
"""
from __future__ import annotations

from typing import Dict

from portbench.counts import h100
from portbench.counts.roofline import bound_s

KERNELS = ("kda_fwd_intra_kernel", "kda_fwd_state_kernel", "kda_bwd_state_kernel",
           "kda_bwd_intra_kernel")


def counts(b: int, s: int, h: int, dk: int, dv: int, c: int) -> Dict[str, tuple]:
    """(bytes, multiply-adds) of one launch of each kernel."""
    n = -(-s // c)
    chunks = b * h * n
    tk, tv = b * s * h * dk, b * s * h * dv  # elements of one key / value tensor
    rows = b * s * h  # elements of β
    states = chunks * dk * dv * 4  # every chunk's [d_k, d_v] fp32 state
    m = chunks * c * c * 4
    return {
        "kda_fwd_intra_kernel": (
            2 * tk * 2 + tv * 2 + tk * 4 + rows * 4 + tk * 2 + tv * 4 + m,
            chunks * c * c * (3 * dk + dv)),
        "kda_fwd_state_kernel": (
            2 * tk * 2 + tk * 4 + tk * 2 + tv * 4 + m + tv * 4 + tv * 2 + states,
            chunks * (3 * c * dk * dv + c * c * dv)),
        "kda_bwd_state_kernel": (
            2 * tk * 2 + tk * 4 + tk * 2 + m + tv * 2 + tv * 4 + states,
            chunks * (3 * c * dk * dv + c * c * dv)),
        "kda_bwd_intra_kernel": (
            2 * tk * 2 + tv * 2 + tk * 4 + rows * 4 + 2 * states + 2 * tv * 4 + tv * 2
            + 2 * tk * 2 + tv * 2 + tk * 4 + rows * 4,
            chunks * (7 * c * c * dk + 3 * c * c * dv + 3 * c * dk * dv + 2 * c ** 3)),
    }


def bounds(b: int, s: int, h: int, dk: int, dv: int, c: int) -> Dict[str, float]:
    """Seconds per launch of each kernel."""
    return {name: bound_s(n_bytes, tensor_cores=2 * macs / h100.BF16_FLOPS)
            for name, (n_bytes, macs) in counts(b, s, h, dk, dv, c).items()}


def forward_macs(dk: int, dv: int, c: int) -> float:
    """Multiply-adds of the forward kernels a token and head (the chunk's
    algebra and its products with the state)."""
    return (c * (3 * dk + dv) + 3 * dk * dv + c * dv)
