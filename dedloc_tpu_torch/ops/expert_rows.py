"""Passes over the dropless expert layer's sorted rows: hand-written Triton
kernels on the card, their plain PyTorch versions on the CPU.

The DeepSeek-V3 expert layer (``parallel/moe.py`` ``routed_experts``) sorts
a call's ``T * k`` (token, expert) pairs by held expert; the first
``offs[-1]`` sorted rows are the pairs whose expert this rank holds, the
rest belong to experts held elsewhere. Group sizes stay on the device (no
host read sizes anything), so every buffer keeps the static ``T * k``
rows. The two grouped products (``torch._grouped_mm``) cost only the live
rows; the passes around them, written eagerly, cost all of them: on one
expert-parallel rank of eight about one row in eight is live. These
kernels read the live count ``offs[-1]`` on the device and do nothing for
the rows past it: the grid stays static and a program past the count
returns at once. They replace no TPU kernel: the JAX package has no
dropless layer.

forward   x -> rows (gather) -> [grouped product] -> h -> act (SwiGLU)
          -> [grouped product] -> out -> y (combine)
backward  dy -> (d_out, d_gates) -> [...] -> dh -> [...] -> d_rows -> dx

Kernels (Triton, built at first launch):

- ``_gather_kernel`` (``expert_gather``): row-parallel over the sorted
  rows. Every row writes its pair's entry of ``inverse [T, k]`` (the sorted
  row of pair ``(t, j)``: a scatter by a permutation, so no two writes
  collide); a live row copies ``x[order[i] // k]`` rounded to the compute
  dtype.
- ``_swiglu_kernel`` (``swiglu_rows``): ``act = bf16(silu(f32(g)) ·
  f32(u))`` for the live rows of ``h = [g | u]``, the rounding points of
  the eager formula.
- ``_swiglu_bwd_kernel`` (``swiglu_rows_bwd``): ``dg = d · u · s · (1 + g
  (1 - s))`` and ``du = d · silu(g)`` (``s = sigmoid(g)``, ``d =
  f32(d_act)``), each rounded to h's dtype, one pass over the live rows.
- ``_combine_kernel`` (``expert_combine``): token-parallel, whole rows of
  ``H``: ``y[t] = Σ_j held · gate[t, j] · f32(src[inverse[t, j]])`` in
  fp32, ``j = 0 … k-1`` in that order; a pair is held where its sorted row
  lies below the live count. Without gates (``gates=None``) it is the
  gather's backward, ``dx[t] = Σ_j held · f32(d_rows[inverse[t, j]])``:
  a fixed-order sum by token, no atomics.
- ``_combine_bwd_kernel`` (``expert_combine_bwd``): token-parallel, whole
  rows: ``d_out[inverse[t, j]] = bf16(gate[t, j] · dy[t])`` for held pairs
  (a scatter by the permutation again) and ``d_gate[t, j] = held ·
  ⟨dy[t], f32(out[inverse[t, j]])⟩`` in fp32.

Rows past the live count of every output are left unwritten: no consumer
reads them (the combine and the gather's backward test ``inverse < live``,
the grouped products' K-grouped weight gradient reads only rows inside its
groups, and a row-grouped product's dead output rows come from dead input
rows alone).

What bounds them on an H100: no matrix product, so memory bandwidth. The
row-parallel passes read and write each live row once; the token-parallel
passes read each token's ``dy`` or write its ``y`` once (``[T, H]`` fp32,
whatever the live share) and each held pair's row once.

Each wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises. ``<wrapper>.launches``
counts launches. The autograd functions (``gather``, ``swiglu``,
``combine``) run a kernel in the forward and one in the backward.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dedloc_tpu_torch.ops import _build
from dedloc_tpu_torch.utils.device import on_card

TILE = 4096  # elements a program holds per step (32 a thread at 4 warps)

# ------------------------------------------------------------ plain versions


def _live(offs: torch.Tensor) -> int:
    return int(offs[-1])  # a host read: the plain versions run on the CPU


def expert_gather_plain(x, order, offs, k: int, dtype):
    """(rows [T*k, H] in ``dtype``, inverse [T, k] int32): the live sorted
    rows' tokens, zeros past the live count; ``inverse[t, j]`` the sorted
    row of pair ``t * k + j``."""
    n = order.numel()
    inverse = torch.empty(n, dtype=torch.int32, device=order.device).scatter_(
        0, order, torch.arange(n, dtype=torch.int32, device=order.device))
    live = _live(offs)
    rows = x.new_zeros((n, x.shape[1]), dtype=dtype)
    rows[:live] = x[order[:live] // k].to(dtype)
    return rows, inverse.view(-1, k)


def swiglu_rows_plain(h, offs):
    """``act [R, F]``: ``silu(g) * u`` of the live rows of ``h = [g | u]``
    in fp32, rounded to h's dtype; zeros past the live count."""
    f = h.shape[1] // 2
    live = _live(offs)
    act = h.new_zeros((h.shape[0], f))
    act[:live] = (F.silu(h[:live, :f].float()) * h[:live, f:].float()).to(h.dtype)
    return act


def swiglu_rows_bwd_plain(h, dact, offs):
    """``dh [R, 2F]`` of ``swiglu_rows`` for the live rows, zeros past."""
    f = h.shape[1] // 2
    live = _live(offs)
    g, u = h[:live, :f].float(), h[:live, f:].float()
    d = dact[:live].float()
    s = torch.sigmoid(g)
    dh = torch.zeros_like(h)
    dh[:live, :f] = (d * u * s * (1 + g * (1 - s))).to(h.dtype)
    dh[:live, f:] = (d * F.silu(g)).to(h.dtype)
    return dh


def _held_rows(inverse, offs):
    """(held [T, k], each pair's sorted row, 0 where not held)."""
    held = inverse < offs[-1]
    return held, torch.where(held, inverse, 0).long()


def expert_combine_plain(src, inverse, offs, gates: Optional[torch.Tensor], out_dtype):
    """``y [T, H]`` in ``out_dtype``: each token's held pairs' rows of
    ``src`` in fp32, times the pair's gate (none: 1), summed over ``j = 0
    … k-1`` in that order."""
    t, k = inverse.shape
    held, rows = _held_rows(inverse, offs)
    y = torch.zeros((t, src.shape[1]), dtype=torch.float32, device=src.device)
    for j in range(k):
        v = src.index_select(0, rows[:, j]).float()
        if gates is not None:
            v = gates[:, j, None].float() * v
        y = y + torch.where(held[:, j, None], v, 0.0)
    return y.to(out_dtype)


def expert_combine_bwd_plain(out, inverse, offs, gates, dy):
    """(d_out [R, H] in out's dtype, zeros at rows of no held pair;
    d_gates [T, k] fp32, zero for a pair not held)."""
    t, k = inverse.shape
    held, rows = _held_rows(inverse, offs)
    dy = dy.float()
    d_out = torch.zeros_like(out)
    d_gates = torch.zeros((t, k), dtype=torch.float32, device=out.device)
    for j in range(k):
        o = out.index_select(0, rows[:, j]).float()
        d_gates[:, j] = torch.where(held[:, j], (dy * o).sum(-1), 0.0)
        sel = held[:, j]
        d_out[rows[sel, j]] = (gates[sel, j, None].float() * dy[sel]).to(out.dtype)
    return d_out, d_gates


# ------------------------------------------------------------------ kernels

_KERNELS = None


def _kernels():
    """Define the Triton kernels on first use (the CPU test environment has
    no Triton, so nothing here runs at import)."""
    global _KERNELS
    if _KERNELS is not None:
        return _KERNELS
    # Triton's compile cache goes beside the CUDA builds, inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(_build.BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def _gather_kernel(X, ORDER, LIVE, ROWS_OUT, INV, n_rows, H, K: tl.constexpr,
                       ROWS: tl.constexpr, BLOCK_H: tl.constexpr):
        pid = tl.program_id(0)
        r = pid * ROWS + tl.arange(0, ROWS)
        pair = tl.load(ORDER + r, mask=r < n_rows, other=0)
        tl.store(INV + pair, r, mask=r < n_rows)
        live = tl.load(LIVE)
        if pid * ROWS < live:
            m = r < live
            src = (pair // K) * H
            dst = r.to(tl.int64) * H
            for h0 in range(0, H, BLOCK_H):
                cols = h0 + tl.arange(0, BLOCK_H)
                mm = m[:, None] & (cols < H)[None, :]
                v = tl.load(X + src[:, None] + cols[None, :], mask=mm)
                tl.store(ROWS_OUT + dst[:, None] + cols[None, :],
                         v.to(ROWS_OUT.dtype.element_ty), mask=mm)

    @triton.jit
    def _swiglu_kernel(HH, LIVE, ACT, F, ROWS: tl.constexpr, BLOCK_F: tl.constexpr):
        pid = tl.program_id(0)
        live = tl.load(LIVE)
        if pid * ROWS < live:
            r = pid * ROWS + tl.arange(0, ROWS)
            m = r < live
            hrow = r.to(tl.int64) * (2 * F)
            arow = r.to(tl.int64) * F
            for f0 in range(0, F, BLOCK_F):
                cols = f0 + tl.arange(0, BLOCK_F)
                mm = m[:, None] & (cols < F)[None, :]
                off = hrow[:, None] + cols[None, :]
                g = tl.load(HH + off, mask=mm, other=0.0).to(tl.float32)
                u = tl.load(HH + off + F, mask=mm, other=0.0).to(tl.float32)
                a = g / (1.0 + tl.exp(-g)) * u
                tl.store(ACT + arow[:, None] + cols[None, :], a.to(ACT.dtype.element_ty),
                         mask=mm)

    @triton.jit
    def _swiglu_bwd_kernel(HH, DACT, LIVE, DH, F, ROWS: tl.constexpr,
                           BLOCK_F: tl.constexpr):
        pid = tl.program_id(0)
        live = tl.load(LIVE)
        if pid * ROWS < live:
            r = pid * ROWS + tl.arange(0, ROWS)
            m = r < live
            hrow = r.to(tl.int64) * (2 * F)
            arow = r.to(tl.int64) * F
            for f0 in range(0, F, BLOCK_F):
                cols = f0 + tl.arange(0, BLOCK_F)
                mm = m[:, None] & (cols < F)[None, :]
                off = hrow[:, None] + cols[None, :]
                g = tl.load(HH + off, mask=mm, other=0.0).to(tl.float32)
                u = tl.load(HH + off + F, mask=mm, other=0.0).to(tl.float32)
                d = tl.load(DACT + arow[:, None] + cols[None, :], mask=mm,
                            other=0.0).to(tl.float32)
                s = 1.0 / (1.0 + tl.exp(-g))
                dg = d * u * s * (1.0 + g * (1.0 - s))
                du = d * (g / (1.0 + tl.exp(-g)))
                tl.store(DH + off, dg.to(DH.dtype.element_ty), mask=mm)
                tl.store(DH + off + F, du.to(DH.dtype.element_ty), mask=mm)

    @triton.jit
    def _combine_kernel(SRC, INV, LIVE, GATE, Y, T, H, K: tl.constexpr,
                        GATED: tl.constexpr, ROWS: tl.constexpr, BLOCK_H: tl.constexpr):
        t = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        tm = t < T
        live = tl.load(LIVE)
        cols = tl.arange(0, BLOCK_H)
        cm = cols < H
        acc = tl.zeros([ROWS, BLOCK_H], dtype=tl.float32)
        for j in tl.static_range(K):  # a fixed order: the same sum on every run
            row = tl.load(INV + t * K + j, mask=tm, other=0)
            held = tm & (row < live)
            v = tl.load(SRC + row.to(tl.int64)[:, None] * H + cols[None, :],
                        mask=held[:, None] & cm[None, :], other=0.0).to(tl.float32)
            if GATED:
                v = tl.load(GATE + t * K + j, mask=held, other=0.0)[:, None] * v
            acc += v
        tl.store(Y + t.to(tl.int64)[:, None] * H + cols[None, :],
                 acc.to(Y.dtype.element_ty), mask=tm[:, None] & cm[None, :])

    @triton.jit
    def _combine_bwd_kernel(OUT, INV, LIVE, GATE, DY, DOUT, DGATE, T, H,
                            K: tl.constexpr, ROWS: tl.constexpr, BLOCK_H: tl.constexpr):
        t = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        tm = t < T
        live = tl.load(LIVE)
        cols = tl.arange(0, BLOCK_H)
        cm = cols < H
        dy = tl.load(DY + t.to(tl.int64)[:, None] * H + cols[None, :],
                     mask=tm[:, None] & cm[None, :], other=0.0).to(tl.float32)
        for j in tl.static_range(K):
            row = tl.load(INV + t * K + j, mask=tm, other=0)
            held = tm & (row < live)
            hm = held[:, None] & cm[None, :]
            off = row.to(tl.int64)[:, None] * H + cols[None, :]
            o = tl.load(OUT + off, mask=hm, other=0.0).to(tl.float32)
            tl.store(DGATE + t * K + j, tl.where(held, tl.sum(dy * o, axis=1), 0.0),
                     mask=tm)
            w = tl.load(GATE + t * K + j, mask=held, other=0.0)
            tl.store(DOUT + off, (w[:, None] * dy).to(DOUT.dtype.element_ty), mask=hm)

    _KERNELS = dict(gather=_gather_kernel, swiglu=_swiglu_kernel,
                    swiglu_bwd=_swiglu_bwd_kernel, combine=_combine_kernel,
                    combine_bwd=_combine_bwd_kernel)
    return _KERNELS


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _row_tile(width: int) -> Tuple[int, int]:
    """(BLOCK, ROWS) of a row-parallel pass: up to 512 columns a step by
    enough rows for a TILE-element tile."""
    block = min(_pow2(width), 512)
    return block, max(1, TILE // block)


def _token_tile(width: int) -> Tuple[int, int, int]:
    """(BLOCK_H, ROWS, warps) of a token-parallel pass: whole rows of
    ``width`` (a dot product over them), as many tokens as fill a TILE."""
    block = _pow2(width)
    return block, max(1, TILE // block), 4 if block <= TILE else 8


def _check(name: str, t: torch.Tensor, dtype=None, dim: Optional[int] = None) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if dim is not None and t.dim() != dim:
        raise ValueError(f"{name}: expected {dim} dims, got {tuple(t.shape)}")


def expert_gather(x, order, offs, k: int, dtype):
    """(rows [T*k, H] in ``dtype``, inverse [T, k] int32): sorted row ``i <
    offs[-1]`` holds token ``order[i] // k`` of ``x [T, H]``; rows past the
    live count are left unwritten."""
    if not on_card(x, "expert gather"):
        return expert_gather_plain(x, order, offs, k, dtype)
    _check("x", x, dim=2)
    _check("order", order, torch.int64, 1)
    _check("offs", offs, torch.int32, 1)
    n, h = order.numel(), x.shape[1]
    if n != x.shape[0] * k:
        raise ValueError(f"order: {n} pairs, expected {x.shape[0]} x {k}")
    rows = torch.empty((n, h), device=x.device, dtype=dtype)
    inverse = torch.empty((n // k, k), device=x.device, dtype=torch.int32)
    block, per = _row_tile(h)
    _kernels()["gather"][(-(-n // per),)](x, order, offs[-1:], rows, inverse, n, h, K=k,
                                          ROWS=per, BLOCK_H=block, num_warps=4)
    expert_gather.launches += 1
    return rows, inverse


def swiglu_rows(h, offs):
    """``act [R, F]`` for the live rows of ``h [R, 2F]``; the rest unwritten."""
    if not on_card(h, "expert SwiGLU"):
        return swiglu_rows_plain(h, offs)
    _check("h", h, dim=2)
    _check("offs", offs, torch.int32, 1)
    r, f = h.shape[0], h.shape[1] // 2
    act = torch.empty((r, f), device=h.device, dtype=h.dtype)
    block, per = _row_tile(f)
    _kernels()["swiglu"][(-(-r // per),)](h, offs[-1:], act, f, ROWS=per, BLOCK_F=block,
                                          num_warps=4)
    swiglu_rows.launches += 1
    return act


def swiglu_rows_bwd(h, dact, offs):
    """``dh [R, 2F]`` for the live rows; the rest unwritten."""
    if not on_card(h, "expert SwiGLU"):
        return swiglu_rows_bwd_plain(h, dact, offs)
    _check("h", h, dim=2)
    _check("d_act", dact, h.dtype, 2)
    _check("offs", offs, torch.int32, 1)
    r, f = h.shape[0], h.shape[1] // 2
    dh = torch.empty_like(h)
    block, per = _row_tile(f)
    _kernels()["swiglu_bwd"][(-(-r // per),)](h, dact, offs[-1:], dh, f, ROWS=per,
                                              BLOCK_F=block, num_warps=4)
    swiglu_rows_bwd.launches += 1
    return dh


def expert_combine(src, inverse, offs, gates: Optional[torch.Tensor], out_dtype):
    """``y [T, H]`` in ``out_dtype``: each token's held pairs' rows of
    ``src [R, H]``, times their ``gates [T, k]`` (fp32; None: 1), summed in
    fp32 in pair order."""
    if not on_card(src, "expert combine"):
        return expert_combine_plain(src, inverse, offs, gates, out_dtype)
    _check("src", src, dim=2)
    _check("inverse", inverse, torch.int32, 2)
    _check("offs", offs, torch.int32, 1)
    if gates is not None:
        _check("gates", gates, torch.float32, 2)
    (t, k), h = inverse.shape, src.shape[1]
    y = torch.empty((t, h), device=src.device, dtype=out_dtype)
    block, per, warps = _token_tile(h)
    _kernels()["combine"][(-(-t // per),)](
        src, inverse, offs[-1:], src if gates is None else gates, y, t, h, K=k,
        GATED=gates is not None, ROWS=per, BLOCK_H=block, num_warps=warps)
    expert_combine.launches += 1
    return y


def expert_combine_bwd(out, inverse, offs, gates, dy):
    """(d_out [R, H] in out's dtype, written at held pairs' rows alone;
    d_gates [T, k] fp32) of ``expert_combine`` with gates."""
    if not on_card(out, "expert combine"):
        return expert_combine_bwd_plain(out, inverse, offs, gates, dy)
    _check("out", out, dim=2)
    _check("inverse", inverse, torch.int32, 2)
    _check("offs", offs, torch.int32, 1)
    _check("gates", gates, torch.float32, 2)
    _check("dy", dy, dim=2)
    (t, k), h = inverse.shape, out.shape[1]
    d_out = torch.empty_like(out)
    d_gates = torch.empty((t, k), device=out.device, dtype=torch.float32)
    block, per, warps = _token_tile(h)
    _kernels()["combine_bwd"][(-(-t // per),)](
        out, inverse, offs[-1:], gates, dy, d_out, d_gates, t, h, K=k, ROWS=per,
        BLOCK_H=block, num_warps=warps)
    expert_combine_bwd.launches += 1
    return d_out, d_gates


expert_gather.launches = 0
swiglu_rows.launches = 0
swiglu_rows_bwd.launches = 0
expert_combine.launches = 0
expert_combine_bwd.launches = 0
WRAPPERS = (expert_gather, swiglu_rows, swiglu_rows_bwd, expert_combine,
            expert_combine_bwd)


# ---------------------------------------------------------------- public ops


class _Gather(torch.autograd.Function):
    """``expert_gather``; the gradient of x sums each token's held rows'
    gradients (``expert_combine`` without gates)."""

    @staticmethod
    def forward(ctx, x, order, offs, k, dtype):
        rows, inverse = expert_gather(x, order, offs, k, dtype)
        ctx.mark_non_differentiable(inverse)
        ctx.save_for_backward(inverse, offs)
        ctx.x_dtype = x.dtype
        return rows, inverse

    @staticmethod
    def backward(ctx, d_rows, _d_inverse):
        inverse, offs = ctx.saved_tensors
        dx = expert_combine(d_rows.contiguous(), inverse, offs, None, ctx.x_dtype)
        return dx, None, None, None, None


class _SwiGLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, offs):
        ctx.save_for_backward(h, offs)
        return swiglu_rows(h, offs)

    @staticmethod
    def backward(ctx, dact):
        h, offs = ctx.saved_tensors
        return swiglu_rows_bwd(h, dact.contiguous(), offs), None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, gates, inverse, offs):
        gates = gates.contiguous()
        ctx.save_for_backward(out, gates, inverse, offs)
        return expert_combine(out, inverse, offs, gates, torch.float32)

    @staticmethod
    def backward(ctx, dy):
        out, gates, inverse, offs = ctx.saved_tensors
        d_out, d_gates = expert_combine_bwd(out, inverse, offs, gates, dy.contiguous())
        return d_out, d_gates, None, None


def gather(x: torch.Tensor, order: torch.Tensor, offs: torch.Tensor, k: int,
           dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows [T*k, H] in ``dtype``, inverse [T, k]) of the pairs sorted by
    ``order`` (``offs``: the int32 end of each held expert's rows)."""
    return _Gather.apply(x, order, offs, k, dtype)


def swiglu(h: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """``silu(g) * u`` of the live rows of ``h = [g | u]``, in h's dtype."""
    return _SwiGLU.apply(h, offs)


def combine(out: torch.Tensor, gates: torch.Tensor, inverse: torch.Tensor,
            offs: torch.Tensor) -> torch.Tensor:
    """``y [T, H]`` fp32: each token's held pairs' rows of ``out``
    weighted by their fp32 ``gates [T, k]``."""
    return _Combine.apply(out, gates, inverse, offs)
