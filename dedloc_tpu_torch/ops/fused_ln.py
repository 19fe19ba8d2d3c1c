"""Fused residual-add + LayerNorm: hand-written Triton kernels on the card,
their plain PyTorch versions on the CPU.

Port of ``dedloc_tpu/ops/fused_ln.py``:

forward   y = LN(x + r) * gamma + beta   one pass: reads x, r; writes y and
                                         the backward's residuals (x̂, rstd),
                                         or y alone for a no-grad call
backward  dy -> (da, dgamma, dbeta)      da serves both dx and dr

Kernels (Triton, built at first launch):

- ``_ln_fwd_kernel`` replaces ``_fwd_kernel`` (the ``pallas_call`` in
  ``_fwd``) and its y-only variant.
- ``_ln_bwd_kernel`` + ``_ln_reduce_kernel`` replace ``_bwd_kernel`` (the
  ``pallas_call`` in ``_bwd``). The TPU kernel summed dgamma/dbeta in a
  resident output block across its sequential grid; CUDA blocks run in no
  order, so each program writes its own partial row and a second pass sums
  the partials in a fixed order (deterministic, no atomics).

What bounds them on an H100: both passes are per-row reductions plus
elementwise work, no matrix product, so memory bandwidth: at the ALBERT-large
slice ([6144, 1024] bf16) the forward moves ~50 MB and the backward ~38 MB,
15 us and 11 us at 3.35 TB/s. The design reads each input once, keeps each
row in registers ([rows, width] tiles of a few rows per program; a run of
rows per program in the backward), and does every statistic in fp32. Triton serves here as well as
CUDA C++: there are no tensor cores to schedule.

Numerics follow the TPU kernel: the residual add, mean, centred variance and
``rstd = rsqrt(var + eps)`` are fp32; x̂ is stored in the input dtype and
rstd in fp32, and the backward reads them back (it does not recompute x̂).
Each wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises. ``<wrapper>.launches`` counts
launches. The forward with residuals is an operator the dispatcher sees
(``dedloc_tpu_torch::ln_fwd``), so a selective-checkpoint policy can keep
(y, x̂, rstd) and a recompute launches nothing.
"""
from __future__ import annotations

import os
from typing import Tuple

import torch

from dedloc_tpu_torch.ops import _build
from dedloc_tpu_torch.telemetry.steps import region
from dedloc_tpu_torch.utils.device import on_card, sm_count

# ------------------------------------------------------------ plain versions


def ln_fwd_plain(x2, r2, gamma, beta, eps: float, with_residuals: bool = True):
    """(y, x̂, rstd) for [N, H] rows; (y, None, None) without residuals."""
    a = x2.float() + r2.float()
    mu = a.mean(-1, keepdim=True)
    centred = a - mu
    var = (centred * centred).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = centred * rstd
    y = (xhat * gamma.float() + beta.float()).to(x2.dtype)
    if not with_residuals:
        return y, None, None
    return y, xhat.to(x2.dtype), rstd[:, 0]


def ln_bwd_plain(xhat, rstd, gamma, dy):
    """(da, dgamma, dbeta) from the saved (x̂, rstd)."""
    xhat32 = xhat.float()
    dy32 = dy.float()
    gdy = dy32 * gamma.float()
    m1 = gdy.mean(-1, keepdim=True)
    m2 = (gdy * xhat32).mean(-1, keepdim=True)
    da = ((gdy - m1 - xhat32 * m2) * rstd[:, None]).to(dy.dtype)
    return da, (dy32 * xhat32).sum(0), dy32.sum(0)


def ln_residual_reference(x, r, gamma, beta, eps: float = 1e-12):
    """Plain twin of ``ln_residual`` (the unfused path): y for [..., H]."""
    return ln_fwd_plain(x, r, gamma, beta, eps, with_residuals=False)[0]


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
    def _ln_fwd_kernel(X, R, G, B, Y, XHAT, RSTD, N, H, eps,
                       BLOCK: tl.constexpr, ROWS: tl.constexpr,
                       WITH_RES: tl.constexpr):
        # a [ROWS, BLOCK] tile: several rows per program
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        cols = tl.arange(0, BLOCK)
        rmask = rows < N
        cmask = cols < H
        mask = rmask[:, None] & cmask[None, :]
        off = rows[:, None].to(tl.int64) * H + cols[None, :]
        a = (tl.load(X + off, mask=mask, other=0.0).to(tl.float32)
             + tl.load(R + off, mask=mask, other=0.0).to(tl.float32))
        mu = tl.sum(a, axis=1) / H
        centred = tl.where(mask, a - mu[:, None], 0.0)
        var = tl.sum(centred * centred, axis=1) / H
        rstd = 1.0 / tl.sqrt(var + eps)
        xhat = centred * rstd[:, None]
        gamma = tl.load(G + cols, mask=cmask, other=0.0)
        beta = tl.load(B + cols, mask=cmask, other=0.0)
        y = xhat * gamma[None, :] + beta[None, :]
        tl.store(Y + off, y.to(Y.dtype.element_ty), mask=mask)
        if WITH_RES:
            tl.store(XHAT + off, xhat.to(XHAT.dtype.element_ty), mask=mask)
            tl.store(RSTD + rows, rstd, mask=rmask)

    @triton.jit
    def _ln_bwd_kernel(XHAT, RSTD, G, DY, DA, PG, PB, N, H, rows_per_prog,
                       BLOCK: tl.constexpr, ROWS: tl.constexpr):
        # a run of rows, ROWS at a time; dgamma/dbeta summed in registers
        # and written once as this program's partial row
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        cmask = cols < H
        gamma = tl.load(G + cols, mask=cmask, other=0.0)
        acc_g = tl.zeros([ROWS, BLOCK], dtype=tl.float32)
        acc_b = tl.zeros([ROWS, BLOCK], dtype=tl.float32)
        for i in range(0, rows_per_prog, ROWS):
            rows = pid * rows_per_prog + i + tl.arange(0, ROWS)
            rmask = rows < N
            m = rmask[:, None] & cmask[None, :]
            off = rows[:, None].to(tl.int64) * H + cols[None, :]
            xhat = tl.load(XHAT + off, mask=m, other=0.0).to(tl.float32)
            dy = tl.load(DY + off, mask=m, other=0.0).to(tl.float32)
            rstd = tl.load(RSTD + rows, mask=rmask, other=0.0)
            gdy = dy * gamma[None, :]
            m1 = tl.sum(gdy, axis=1) / H
            m2 = tl.sum(gdy * xhat, axis=1) / H
            da = (gdy - m1[:, None] - xhat * m2[:, None]) * rstd[:, None]
            tl.store(DA + off, da.to(DA.dtype.element_ty), mask=m)
            acc_g += dy * xhat
            acc_b += dy
        part = pid.to(tl.int64) * H + cols
        tl.store(PG + part, tl.sum(acc_g, axis=0), mask=cmask)
        tl.store(PB + part, tl.sum(acc_b, axis=0), mask=cmask)

    @triton.jit
    def _ln_reduce_kernel(PG, PB, DG, DB, P, H, BLOCK_P: tl.constexpr,
                          BLOCK: tl.constexpr):
        # fixed tiles in a fixed order: the same sum on every run
        cols = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        cmask = cols < H
        acc_g = tl.zeros([BLOCK_P, BLOCK], dtype=tl.float32)
        acc_b = tl.zeros([BLOCK_P, BLOCK], dtype=tl.float32)
        for p0 in range(0, P, BLOCK_P):
            rows = p0 + tl.arange(0, BLOCK_P)
            m = (rows[:, None] < P) & cmask[None, :]
            off = rows[:, None].to(tl.int64) * H + cols[None, :]
            acc_g += tl.load(PG + off, mask=m, other=0.0)
            acc_b += tl.load(PB + off, mask=m, other=0.0)
        tl.store(DG + cols, tl.sum(acc_g, axis=0), mask=cmask)
        tl.store(DB + cols, tl.sum(acc_b, axis=0), mask=cmask)

    _KERNELS = (triton, _ln_fwd_kernel, _ln_bwd_kernel, _ln_reduce_kernel)
    return _KERNELS


def _check_rows(name: str, t: torch.Tensor, n: int, h: int) -> None:
    if tuple(t.shape) != (n, h) or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous ({n}, {h}), got "
                         f"{tuple(t.shape)} strides {t.stride()}")


def _check_vec(name: str, t: torch.Tensor, h: int) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != (h,) or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous fp32 ({h},), got "
                         f"{t.dtype} {tuple(t.shape)}")


def _tile(h: int):
    """(BLOCK, ROWS, num_warps) for rows of width h: a power-of-two BLOCK
    covering the row, and up to 4 rows per program while the tile stays
    within 4096 elements (32 per thread at 4 warps)."""
    block = 1 << max(h - 1, 0).bit_length()
    rows = max(1, min(4, 4096 // block))
    return block, rows, 4 if block * rows <= 4096 else 8


def ln_fwd(x2, r2, gamma, beta, eps: float, with_residuals: bool = True):
    """Fused add+LN forward on [N, H] rows: (y, x̂, rstd), or (y, None, None)
    with ``with_residuals=False`` (the y-only variant)."""
    if not on_card(x2, "fused add+LayerNorm"):
        return ln_fwd_plain(x2, r2, gamma, beta, eps, with_residuals)
    n, h = x2.shape
    _check_rows("x", x2, n, h)
    _check_rows("r", r2, n, h)
    _check_vec("gamma", gamma, h)
    _check_vec("beta", beta, h)
    triton, fwd_kernel, _, _ = _kernels()
    y = torch.empty_like(x2)
    xhat = torch.empty_like(x2) if with_residuals else y
    rstd = (torch.empty(n, device=x2.device, dtype=torch.float32)
            if with_residuals else gamma)
    block, rows, warps = _tile(h)
    fwd_kernel[(triton.cdiv(n, rows),)](
        x2, r2, gamma, beta, y, xhat, rstd, n, h, float(eps),
        BLOCK=block, ROWS=rows, WITH_RES=with_residuals, num_warps=warps)
    ln_fwd.launches += 1
    if not with_residuals:
        return y, None, None
    return y, xhat, rstd


def ln_bwd(xhat, rstd, gamma, dy):
    """Fused add+LN backward: (da [N, H] in dy's dtype, dgamma, dbeta fp32)."""
    if not on_card(dy, "fused add+LayerNorm"):
        return ln_bwd_plain(xhat, rstd, gamma, dy)
    n, h = dy.shape
    _check_rows("xhat", xhat, n, h)
    _check_rows("dy", dy, n, h)
    _check_vec("gamma", gamma, h)
    if rstd.dtype != torch.float32 or tuple(rstd.shape) != (n,):
        raise ValueError(f"rstd: expected fp32 ({n},), got {rstd.dtype} "
                         f"{tuple(rstd.shape)}")
    triton, _, bwd_kernel, reduce_kernel = _kernels()
    block, rows, warps = _tile(h)
    # 2 programs per SM, each a run of rows (a multiple of the tile's) and
    # one partial row of dgamma/dbeta
    n_programs = 2 * sm_count(dy.device)
    rows_per_prog = triton.cdiv(triton.cdiv(n, n_programs), rows) * rows
    parts = triton.cdiv(n, rows_per_prog)
    da = torch.empty_like(dy)
    pg = torch.empty((parts, h), device=dy.device, dtype=torch.float32)
    pb = torch.empty_like(pg)
    dgamma = torch.empty(h, device=dy.device, dtype=torch.float32)
    dbeta = torch.empty_like(dgamma)
    bwd_kernel[(parts,)](xhat, rstd, gamma, dy, da, pg, pb, n, h,
                         rows_per_prog, BLOCK=block, ROWS=rows,
                         num_warps=warps)
    reduce_kernel[(triton.cdiv(h, 32),)](
        pg, pb, dgamma, dbeta, parts, h, BLOCK_P=64, BLOCK=32, num_warps=4)
    ln_bwd.launches += 1
    return da, dgamma, dbeta


ln_fwd.launches = 0
ln_bwd.launches = 0
WRAPPERS = (ln_fwd, ln_bwd)


# ----------------------------------------------------------------- public op


@torch.library.custom_op("dedloc_tpu_torch::ln_fwd", mutates_args=())
def _ln_fwd_op(x2: torch.Tensor, r2: torch.Tensor, gamma: torch.Tensor,
               beta: torch.Tensor, eps: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return ln_fwd(x2, r2, gamma, beta, eps)


@_ln_fwd_op.register_fake
def _(x2, r2, gamma, beta, eps):
    return (torch.empty_like(x2), torch.empty_like(x2),
            x2.new_empty(x2.shape[:1], dtype=torch.float32))


def _ln_setup(ctx, inputs, output):
    _, xhat, rstd = output
    ctx.save_for_backward(xhat, rstd, inputs[2])
    ctx.r_dtype = inputs[1].dtype
    ctx.mark_non_differentiable(xhat, rstd)


def _ln_backward(ctx, dy, _dxhat, _drstd):
    # a remat block recomputes its forward here, in its own regions
    xhat, rstd, gamma = ctx.saved_tensors
    with region("norm"):
        da, dgamma, dbeta = ln_bwd(xhat, rstd, gamma, dy.contiguous())
        # the residual add fans the same cotangent to both inputs
        return da, da.to(ctx.r_dtype), dgamma, dbeta, None


_ln_fwd_op.register_autograd(_ln_backward, setup_context=_ln_setup)

#: The forward's operator, as a selective-checkpoint policy sees it.
FORWARD_OP = torch.ops.dedloc_tpu_torch.ln_fwd.default


def ln_residual(
    x: torch.Tensor,  # [..., H] (the matmul-output branch)
    r: torch.Tensor,  # [..., H] (the residual branch)
    gamma: torch.Tensor,  # [H] fp32
    beta: torch.Tensor,  # [H] fp32
    eps: float = 1e-12,
) -> torch.Tensor:
    """``LayerNorm(x + r) * gamma + beta`` as one fused pass each way (fp32
    statistics), returned in ``x.dtype``. Without autograd (no grad mode, or
    no input requiring grad) the y-only forward runs."""
    h = x.shape[-1]
    x2 = x.reshape(-1, h).contiguous()
    r2 = r.reshape(-1, h).contiguous()
    gamma = gamma.to(torch.float32).contiguous()
    beta = beta.to(torch.float32).contiguous()
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, r, gamma, beta)
    ):
        y = _ln_fwd_op(x2, r2, gamma, beta, float(eps))[0]
    else:
        y, _, _ = ln_fwd(x2, r2, gamma, beta, float(eps), with_residuals=False)
    return y.reshape(x.shape)
