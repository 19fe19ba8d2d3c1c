"""Exact fused attention: a hand-written CUDA kernel on the card, its plain
PyTorch version on the CPU.

Port of ``dedloc_tpu/ops/flash_attention.py``. The public op keeps the JAX
layout: ``q, k, v`` are ``[B, S, H, D]`` and ``bias`` is an additive per-key
``[B, S_kv]`` row (0 keep / -1e9 drop, what ``AlbertModel`` builds), broadcast
over heads and not differentiated.

Three kernels, in ``csrc/flash_attention.cu`` (built by ``_build.py``):

- ``flash_fwd``: replaces ``_fwd_kernel`` (the ``pallas_call`` in ``_fwd``).
  One block per 128-row query tile, streaming 128-key tiles of K and V with
  an online softmax. Writes ``out`` and ``lse = m + log(max(l, 1e-30))``.
- ``flash_bwd_dkdv`` and ``flash_bwd_dq``: one block per 128-row key
  (dK/dV) or query (dQ) tile, streaming 64-row tiles of the other side at
  any S, they replace both backward paths of ``_bwd``: the split
  ``_dkv_kernel``/``_dq_kernel`` pair that JAX runs when S exceeds its block
  (the S=16,384 long-context step) and the single-tile
  ``_dqkv_fused_kernel`` it runs otherwise (the seq-512 step).
  ``delta = rowsum(dO * out)`` is computed outside the kernels in fp32, as
  the JAX custom VJP does.

All three run their products on ``wgmma``, fed by a TMA ring
(``csrc/hopper.cuh``).

The forward is an operator the dispatcher sees (``dedloc_tpu_torch::
flash_fwd``, registered with ``torch.library``), so a selective-checkpoint
policy can keep its ``out`` and ``lse`` and a recompute launches nothing
(``models/albert.py`` ``remat_policy_object``).

The source's header says what bounds each kernel on an H100 and how the
design answers it. Each wrapper takes the plain version only for a tensor on
the CPU; for a CUDA tensor it launches the kernel (bf16, D a multiple of 16
up to 128) or raises. ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dedloc_tpu_torch.ops import _build
from dedloc_tpu_torch.utils.device import on_card

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
FWD_TILE = 128  # query rows per forward block
BWD_TILE = 128  # key (dK/dV) or query (dQ) rows per backward block
MAX_GRID_Y = 65535  # the grids are (B*H, tiles): y is at most 65535


# ------------------------------------------------------------ plain versions


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] -> [B, H, S, D] in fp32 (values rounded as stored)."""
    return x.permute(0, 2, 1, 3).float()


def _scores(q, k, bias):
    """s = (q . k) * D^-1/2 + bias in fp32, as [B, H, Sq, Sk]."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = _heads_first(q) @ _heads_first(k).transpose(-1, -2)
    return s * scale + bias.float()[:, None, None, :]


def flash_fwd_plain(q, k, v, bias) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function on one tile covering the whole sequence:
    returns ``out`` [B, S, H, D] in q's dtype and ``lse`` [B*H, S] fp32."""
    b, s, h, _ = q.shape
    sc = _scores(q, k, bias)
    m = sc.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(sc - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    acc = p.to(v.dtype).float() @ _heads_first(v)
    out = (acc / l).to(q.dtype).permute(0, 2, 1, 3)
    lse = (m + torch.log(l)).reshape(b * h, s)
    return out, lse


def _probs_and_dscores(q, k, v, bias, lse, dout, delta):
    b, s, h, _ = q.shape
    scale = 1.0 / (q.shape[-1] ** 0.5)
    p = torch.exp(_scores(q, k, bias) - lse.reshape(b, h, s, 1))
    dp = _heads_first(dout) @ _heads_first(v).transpose(-1, -2)
    ds = (p * (dp - delta.reshape(b, h, s, 1)) * scale).to(q.dtype)
    return p, ds


def flash_bwd_dkdv_plain(q, k, v, bias, lse, dout, delta):
    p, ds = _probs_and_dscores(q, k, v, bias, lse, dout, delta)
    dv = p.to(dout.dtype).float().transpose(-1, -2) @ _heads_first(dout)
    dk = ds.float().transpose(-1, -2) @ _heads_first(q)
    return (dk.to(k.dtype).permute(0, 2, 1, 3),
            dv.to(v.dtype).permute(0, 2, 1, 3))


def flash_bwd_dq_plain(q, k, v, bias, lse, dout, delta):
    _, ds = _probs_and_dscores(q, k, v, bias, lse, dout, delta)
    dq = ds.float() @ _heads_first(k)
    return dq.to(q.dtype).permute(0, 2, 1, 3)


# ---------------------------------------------------------- kernel wrappers


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd.argtypes = [p] * 10 + [i] * 4 + [f, p]
        lib.flash_bwd_dkdv.argtypes = [p] * 15 + [i] * 4 + [f, p]
        lib.flash_bwd_dq.argtypes = [p] * 13 + [i] * 4 + [f, p]
        for fn in (lib.flash_fwd, lib.flash_bwd_dkdv, lib.flash_bwd_dq):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _strides(t: torch.Tensor):
    arr = (ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2))
    return arr, ctypes.cast(arr, ctypes.c_void_p)


def _check_bshd(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bf16, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.stride(3) != 1 or any(t.stride(i) % 8 for i in range(3)):
        raise ValueError(
            f"{name}: last dim must be contiguous and other strides multiples "
            f"of 8 (16-byte vector loads), got strides {t.stride()}"
        )
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def _check_f32(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected fp32 {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_common(q, k, v, bias, tile: int):
    """Shapes, types and strides the kernels take, for a grid of ``tile``-row
    blocks along S; returns (B, S, H, D)."""
    b, s, h, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} unsupported: the kernel takes "
                         f"{SUPPORTED_HEAD_DIMS}")
    if -(-s // tile) > MAX_GRID_Y:
        raise ValueError(f"S={s}: the kernel takes at most {MAX_GRID_Y} "
                         f"tiles of {tile}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_bshd(name, t, (b, s, h, d))
    _check_f32("bias", bias, (b, s))
    return b, s, h, d


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def flash_fwd(q, k, v, bias) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, S, H, D], lse [B*H, S] fp32) for ``[B, S, H, D]`` inputs and
    an fp32 ``[B, S]`` additive key bias."""
    if not on_card(q, "flash attention"):
        return flash_fwd_plain(q, k, v, bias)
    b, s, h, d = _check_common(q, k, v, bias, FWD_TILE)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b * h, s), device=q.device, dtype=torch.float32)
    keep = [_strides(t) for t in (q, k, v, out)]
    err = _lib().flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(), *[ptr for _, ptr in keep],
        b, s, h, d, 1.0 / (d ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


def flash_bwd_dkdv(q, k, v, bias, lse, dout, delta):
    """(dk, dv), each ``[B, S, H, D]`` in the input dtype."""
    if not on_card(q, "flash attention"):
        return flash_bwd_dkdv_plain(q, k, v, bias, lse, dout, delta)
    b, s, h, d = _check_common(q, k, v, bias, BWD_TILE)
    _check_bshd("dout", dout, (b, s, h, d))
    _check_f32("lse", lse, (b * h, s))
    _check_f32("delta", delta, (b * h, s))
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    keep = [_strides(t) for t in (q, k, v, dout, dk, dv)]
    err = _lib().flash_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dout.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *[ptr for _, ptr in keep],
        b, s, h, d, 1.0 / (d ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_bwd_dkdv")
    flash_bwd_dkdv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, bias, lse, dout, delta):
    """dq ``[B, S, H, D]`` in the input dtype."""
    if not on_card(q, "flash attention"):
        return flash_bwd_dq_plain(q, k, v, bias, lse, dout, delta)
    b, s, h, d = _check_common(q, k, v, bias, BWD_TILE)
    _check_bshd("dout", dout, (b, s, h, d))
    _check_f32("lse", lse, (b * h, s))
    _check_f32("delta", delta, (b * h, s))
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    keep = [_strides(t) for t in (q, k, v, dout, dq)]
    err = _lib().flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dout.data_ptr(), dq.data_ptr(),
        *[ptr for _, ptr in keep],
        b, s, h, d, 1.0 / (d ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_fwd.launches = 0
flash_bwd_dkdv.launches = 0
flash_bwd_dq.launches = 0
WRAPPERS = (flash_fwd, flash_bwd_dkdv, flash_bwd_dq)


def softmax_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * out) in fp32, as ``[B*H, S]``."""
    b, s, h, _ = out.shape
    prod = (dout.float() * out.float()).sum(-1)  # [B, S, H]
    return prod.permute(0, 2, 1).reshape(b * h, s).contiguous()


# ----------------------------------------------------------------- public op


@torch.library.custom_op("dedloc_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_fwd(q, k, v, bias)


@_flash_fwd_op.register_fake
def _(q, k, v, bias):
    b, s, h, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((b * h, s), dtype=torch.float32))


def _flash_setup(ctx, inputs, output):
    out, lse = output
    ctx.save_for_backward(*inputs, out, lse)
    ctx.mark_non_differentiable(lse)


def _flash_backward(ctx, dout, _dlse):
    q, k, v, bias, out, lse = ctx.saved_tensors
    dout = dout.contiguous()
    delta = softmax_delta(out, dout)
    dk, dv = flash_bwd_dkdv(q, k, v, bias, lse, dout, delta)
    dq = flash_bwd_dq(q, k, v, bias, lse, dout, delta)
    # the mask bias is a non-differentiable input: zero gradient
    dbias = torch.zeros_like(bias) if ctx.needs_input_grad[3] else None
    return dq, dk, dv, dbias


_flash_fwd_op.register_autograd(_flash_backward, setup_context=_flash_setup)

#: The forward's operator, as a selective-checkpoint policy sees it.
FORWARD_OP = torch.ops.dedloc_tpu_torch.flash_fwd.default


def flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,  # [B, S_kv] additive
) -> torch.Tensor:
    """Exact attention, ``[B, S, H, D]`` out, differentiable in q, k, v."""
    if bias is None:
        bias = torch.zeros(q.shape[:2], device=q.device, dtype=torch.float32)
    bias = bias.to(torch.float32).contiguous()
    return _flash_fwd_op(q, k, v, bias)[0]
