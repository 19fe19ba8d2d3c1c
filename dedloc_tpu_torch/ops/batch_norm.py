"""Fused batch norm over channels-last rows: hand-written Triton kernels on
the card, their plain PyTorch versions on the CPU.

The ResNet trunk's and the SwAV head's batch norms (``models/resnet.py``
``BatchNorm``) on ``[M, C]`` rows with the channels contiguous: an NHWC
(channels-last) convolution output viewed as ``[N*H*W, C]``, or the head's
``[N, C]``. They replace no TPU kernel: the JAX package leaves flax's
``nn.BatchNorm`` to XLA, which fuses it into the reductions and the
convolutions' epilogues. Eagerly, the same chain (an fp32 copy of the bf16
input, strided reductions, one fp32 tensor per elementwise op, separate
ReLU and residual add) takes ~20 launches and ~50 bytes an element each
way, and autograd keeps several fp32 copies of every activation.

forward   x -> y = epilogue((x - mean) * (rsqrt(var + eps) * weight) + bias)
          epilogue: none, ReLU, or ReLU(residual + .)
backward  dy -> (dx, dweight, dbias, dresidual)

Kernels (Triton, built at first launch):

- ``_bn_stats_kernel``: each program a run of rows of ``BLOCK_C``
  channels; Σx and Σx² in fp32 registers, written once as its partial row.
- ``_bn_moments_kernel``: the partial rows summed in a fixed order (the
  same sum on every run, no atomics), then flax's statistics: ``mean =
  Σx / M`` and ``mean2 = Σx² / M`` as IEEE divisions (``utils/device.py``
  ``divide``), ``var = mean2 - mean²`` kept raw (clamped at 0 where it is
  used), and the running statistics ``0.9 ra + 0.1 stat`` with the biased
  variance. On a slice mesh it first writes this rank's ``[Σx, Σx², M]``,
  which cross one all-reduce over ``data``, and runs again on the slice's.
- ``_bn_apply_kernel``: one elementwise pass; the per-channel scale formed
  once per program; the epilogue; the output in the consumer's dtype (bf16
  where a bf16 convolution alone reads it); with a residual and ReLU, the
  ReLU's mask as one byte an element.
- ``_bn_grad_sums_kernel`` + ``_bn_grad_reduce_kernel``: ``g = dy`` through
  the ReLU (its mask recomputed from x and the per-channel statistics, or
  the saved byte), then ``dbias = Σg`` and ``dweight = rstd · Σg (x -
  mean)`` (partials, then a fixed-order pass).
- ``_bn_dx_kernel``: ``dx = weight · rstd · (g - Σg / M - x̂ · dweight /
  M)`` in x's dtype; the variance term dropped for a channel whose raw
  variance was negative (``clamp_min`` passes no gradient there); the
  residual's gradient ``g``. In eval mode the statistics take no gradient:
  ``dx = weight · rstd · g``.

What bounds them on an H100: no matrix product, so memory bandwidth. The
design reads the bf16 input twice forward (statistics, normalise) and twice
backward, writes each output once, and the backward saves only the input
(plus the one-byte mask of a residual ReLU), no fp32 activation. Triton
serves as well as CUDA C++: there are no tensor cores to schedule.

Each wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises. ``<wrapper>.launches`` counts
launches (one a call, whatever the kernels inside it).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from dedloc_tpu_torch.ops import _build
from dedloc_tpu_torch.parallel.mesh import all_reduce
from dedloc_tpu_torch.telemetry.steps import region
from dedloc_tpu_torch.utils.device import divide, on_card, sm_count

# programs a run-of-rows kernel puts on each SM: enough loads in flight to
# keep HBM busy at every shape (3.2 M rows of 64 channels to 1,024 of 2,048)
PROGRAMS_PER_SM = 8
TILE = 4096  # elements a program holds per step (32 a thread at 4 warps)

# ------------------------------------------------------------ plain versions


def _slice_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the slice's ``data`` ranks (``t`` without one)."""
    return t if mesh is None else all_reduce(t, mesh, "data")


def _clamp0(var: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(var, 0.0)


def bn_stats_plain(x2, running_mean, running_var, momentum: float, mesh=None):
    """(st, new running mean, new running var) of [M, C] rows: ``st`` is
    fp32 ``[mean (C), raw var (C), M (1)]`` over the slice's rows."""
    x = x2.float()
    local = torch.cat([x.sum(0), (x * x).sum(0), x.new_full((1,), float(x.shape[0]))])
    total = _slice_sum(local, mesh)
    c = x.shape[1]
    n = total[2 * c]
    mean, mean2 = total[:c] / n, total[c:2 * c] / n
    var = mean2 - mean * mean
    m = momentum
    return (torch.cat([mean, var, total[2 * c:]]),
            m * running_mean + (1 - m) * mean, m * running_var + (1 - m) * _clamp0(var))


def _scale(var, weight, eps: float):
    rstd = torch.rsqrt(_clamp0(var) + eps)
    return rstd, rstd * weight


def bn_apply_plain(x2, mean, var, weight, bias, eps: float, relu: bool,
                   residual=None, out_dtype=torch.float32, with_mask: bool = False):
    """(y, mask): y = [ReLU]([residual +] (x - mean) * mul + bias) in
    ``out_dtype``; ``mask`` (uint8, ReLU's y > 0) with ``with_mask``."""
    _, mul = _scale(var, weight, eps)
    y = (x2.float() - mean) * mul + bias
    if residual is not None:
        y = residual.float() + y
    mask = None
    if relu:
        if with_mask:
            mask = (y > 0).to(torch.uint8)
        y = torch.relu(y)
    return y.to(out_dtype), mask


def _through_relu(x, dy, mask, mean, var, weight, bias, eps: float, relu: bool):
    """dy where the forward's ReLU passed it: the saved mask, or the sign of
    the normalised x recomputed."""
    dy = dy.float()
    if not relu:
        return dy
    if mask is None:
        _, mul = _scale(var, weight, eps)
        keep = (x - mean) * mul + bias > 0
    else:
        keep = mask.bool()
    return torch.where(keep, dy, 0.0)


def bn_grad_sums_plain(x2, dy, mask, mean, var, weight, bias, eps: float, relu: bool):
    """fp32 ``[dbias (C), dweight (C)]``: Σg and rstd · Σg (x - mean)."""
    x = x2.float()
    g = _through_relu(x, dy, mask, mean, var, weight, bias, eps, relu)
    rstd, _ = _scale(var, weight, eps)
    return torch.cat([g.sum(0), (g * (x - mean)).sum(0) * rstd])


def bn_dx_plain(x2, dy, mask, mean, var, count, weight, bias, d, eps: float,
                relu: bool, residual_dtype=None):
    """(dx in x's dtype, the residual's gradient or None). ``d`` is
    ``[Σg, Σg x̂]`` over the slice's rows; ``count`` its row count (fp32
    [1]), or None in eval mode (the statistics take no gradient)."""
    x = x2.float()
    g = _through_relu(x, dy, mask, mean, var, weight, bias, eps, relu)
    rstd, mul = _scale(var, weight, eps)
    if count is None:
        dx = mul * g
    else:
        c = x.shape[1]
        n = count[0]
        k = torch.where(var >= 0, d[c:] / n * rstd, 0.0)
        dx = mul * (g - d[:c] / n - (x - mean) * k)
    dr = None if residual_dtype is None else g.to(residual_dtype)
    return dx.to(x2.dtype), dr


def batch_norm_reference(x, weight, bias, running_mean, running_var, *, train: bool,
                         momentum: float, eps: float, relu: bool = False,
                         residual=None, out_dtype=torch.float32):
    """The plain formula this module fuses, differentiated by autograd:
    flax's batch norm over every axis but axis 1 (fp32 statistics, the
    variance ``E[x²] - E[x]²`` clamped at 0), then ``[ReLU]([residual +]
    .)``, cast to ``out_dtype``. (y, new running mean, new running var)."""
    x = x.float()
    dims = [d for d in range(x.dim()) if d != 1]
    count = x.numel() // x.shape[1]
    if train:
        mean = divide(x.sum(dims), count)
        var = torch.clamp_min(divide((x * x).sum(dims), count) - mean * mean, 0.0)
        new_mean = momentum * running_mean + (1 - momentum) * mean.detach()
        new_var = momentum * running_var + (1 - momentum) * var.detach()
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mul = torch.rsqrt(var + eps) * weight
    y = (x - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    if residual is not None:
        y = residual + y
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype), new_mean, new_var


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
    def _clamp0_t(v):
        # clamp_min(v, 0) with NaN kept, as PyTorch's
        return tl.where(v < 0, 0.0, v)

    @triton.jit
    def _channels(MEAN, VAR, W, B, cols, cmask, eps):
        mean = tl.load(MEAN + cols, mask=cmask, other=0.0)
        rstd = tl.math.rsqrt(_clamp0_t(tl.load(VAR + cols, mask=cmask, other=0.0)) + eps)
        mul = rstd * tl.load(W + cols, mask=cmask, other=0.0)
        bias = tl.load(B + cols, mask=cmask, other=0.0)
        return mean, rstd, mul, bias

    @triton.jit
    def _through_relu_t(x, dy, MASK, off, m, mean, mul, bias,
                        RELU: tl.constexpr, SAVED: tl.constexpr):
        if RELU:
            if SAVED:
                keep = tl.load(MASK + off, mask=m, other=0) != 0
            else:  # the forward's expression, so the same sign
                keep = (x - mean[None, :]) * mul[None, :] + bias[None, :] > 0
            dy = tl.where(keep, dy, 0.0)
        return dy

    @triton.jit
    def _sum_partials(PART, P, C, cols, cmask, BLOCK_P: tl.constexpr,
                      BLOCK_C: tl.constexpr):
        # fixed tiles in a fixed order: the same sum on every run
        acc1 = tl.zeros([BLOCK_P, BLOCK_C], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK_P, BLOCK_C], dtype=tl.float32)
        for p0 in range(0, P, BLOCK_P):
            rows = p0 + tl.arange(0, BLOCK_P)
            m = (rows[:, None] < P) & cmask[None, :]
            off = rows[:, None].to(tl.int64) * (2 * C) + cols[None, :]
            acc1 += tl.load(PART + off, mask=m, other=0.0)
            acc2 += tl.load(PART + off + C, mask=m, other=0.0)
        return tl.sum(acc1, axis=0), tl.sum(acc2, axis=0)

    @triton.jit
    def _bn_stats_kernel(X, PART, M, C, rows_per_prog, ROWS: tl.constexpr,
                         BLOCK_C: tl.constexpr):
        # a run of rows, ROWS at a time; Σx, Σx² summed in registers and
        # written once as this program's partial row
        pid = tl.program_id(0)
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        acc1 = tl.zeros([ROWS, BLOCK_C], dtype=tl.float32)
        acc2 = tl.zeros([ROWS, BLOCK_C], dtype=tl.float32)
        for i in range(0, rows_per_prog, ROWS):
            rows = pid * rows_per_prog + i + tl.arange(0, ROWS)
            m = (rows < M)[:, None] & cmask[None, :]
            off = rows[:, None].to(tl.int64) * C + cols[None, :]
            x = tl.load(X + off, mask=m, other=0.0).to(tl.float32)
            acc1 += x
            acc2 += x * x
        part = PART + pid.to(tl.int64) * (2 * C) + cols
        tl.store(part, tl.sum(acc1, axis=0), mask=cmask)
        tl.store(part + C, tl.sum(acc2, axis=0), mask=cmask)

    @triton.jit
    def _bn_moments_kernel(PART, P, n, RA_M, RA_V, OUT, NEW_M, NEW_V, C, momentum,
                           rest, FINAL: tl.constexpr, COUNT_IN: tl.constexpr,
                           BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        # OUT: [Σx, Σx², n] (not FINAL, for the slice's all-reduce) or
        # [mean, raw var, n] with the new running statistics (FINAL)
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        s1, s2 = _sum_partials(PART, P, C, cols, cmask, BLOCK_P, BLOCK_C)
        if COUNT_IN:  # the slice's row count, all-reduced beside the sums
            count = tl.load(PART + 2 * C + cols * 0)
        else:
            count = tl.zeros([BLOCK_C], dtype=tl.float32) + n
        if FINAL:
            mean = tl.math.div_rn(s1, count)
            var = tl.math.div_rn(s2, count) - mean * mean
            tl.store(OUT + cols, mean, mask=cmask)
            tl.store(OUT + C + cols, var, mask=cmask)
            ra_m = tl.load(RA_M + cols, mask=cmask, other=0.0)
            ra_v = tl.load(RA_V + cols, mask=cmask, other=0.0)
            tl.store(NEW_M + cols, momentum * ra_m + rest * mean, mask=cmask)
            tl.store(NEW_V + cols, momentum * ra_v + rest * _clamp0_t(var), mask=cmask)
        else:
            tl.store(OUT + cols, s1, mask=cmask)
            tl.store(OUT + C + cols, s2, mask=cmask)
        tl.store(OUT + 2 * C + cols, count, mask=cols == 0)

    @triton.jit
    def _bn_apply_kernel(X, MEAN, VAR, W, B, R, Y, MASK, M, C, eps,
                         RELU: tl.constexpr, RES: tl.constexpr, SAVE_MASK: tl.constexpr,
                         ROWS: tl.constexpr, BLOCK_C: tl.constexpr):
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        m = (rows < M)[:, None] & cmask[None, :]
        off = rows[:, None].to(tl.int64) * C + cols[None, :]
        mean, _rstd, mul, bias = _channels(MEAN, VAR, W, B, cols, cmask, eps)
        x = tl.load(X + off, mask=m, other=0.0).to(tl.float32)
        y = (x - mean[None, :]) * mul[None, :] + bias[None, :]
        if RES:
            y = tl.load(R + off, mask=m, other=0.0).to(tl.float32) + y
        if RELU:
            if SAVE_MASK:
                tl.store(MASK + off, (y > 0).to(tl.uint8), mask=m)
            y = tl.where(y < 0, 0.0, y)  # ReLU, NaN kept
        tl.store(Y + off, y.to(Y.dtype.element_ty), mask=m)

    @triton.jit
    def _bn_grad_sums_kernel(X, DY, MASK, MEAN, VAR, W, B, PART, M, C, rows_per_prog,
                             eps, RELU: tl.constexpr, SAVED: tl.constexpr,
                             ROWS: tl.constexpr, BLOCK_C: tl.constexpr):
        # a run of rows; Σg and Σg (x - mean) in registers, one partial row
        pid = tl.program_id(0)
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        mean, _rstd, mul, bias = _channels(MEAN, VAR, W, B, cols, cmask, eps)
        acc_g = tl.zeros([ROWS, BLOCK_C], dtype=tl.float32)
        acc_gc = tl.zeros([ROWS, BLOCK_C], dtype=tl.float32)
        for i in range(0, rows_per_prog, ROWS):
            rows = pid * rows_per_prog + i + tl.arange(0, ROWS)
            m = (rows < M)[:, None] & cmask[None, :]
            off = rows[:, None].to(tl.int64) * C + cols[None, :]
            x = tl.load(X + off, mask=m, other=0.0).to(tl.float32)
            dy = tl.load(DY + off, mask=m, other=0.0).to(tl.float32)
            g = _through_relu_t(x, dy, MASK, off, m, mean, mul, bias, RELU, SAVED)
            acc_g += g
            acc_gc += g * (x - mean[None, :])
        part = PART + pid.to(tl.int64) * (2 * C) + cols
        tl.store(part, tl.sum(acc_g, axis=0), mask=cmask)
        tl.store(part + C, tl.sum(acc_gc, axis=0), mask=cmask)

    @triton.jit
    def _bn_grad_reduce_kernel(PART, P, VAR, D, C, eps, BLOCK_P: tl.constexpr,
                               BLOCK_C: tl.constexpr):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        s_g, s_gc = _sum_partials(PART, P, C, cols, cmask, BLOCK_P, BLOCK_C)
        var = tl.load(VAR + cols, mask=cmask, other=0.0)
        tl.store(D + cols, s_g, mask=cmask)
        tl.store(D + C + cols, s_gc * tl.math.rsqrt(_clamp0_t(var) + eps), mask=cmask)

    @triton.jit
    def _bn_dx_kernel(X, DY, MASK, MEAN, VAR, COUNT, W, B, D, DX, DR, M, C, eps,
                      RELU: tl.constexpr, SAVED: tl.constexpr, TRAIN: tl.constexpr,
                      RES: tl.constexpr, ROWS: tl.constexpr, BLOCK_C: tl.constexpr):
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        m = (rows < M)[:, None] & cmask[None, :]
        off = rows[:, None].to(tl.int64) * C + cols[None, :]
        mean, rstd, mul, bias = _channels(MEAN, VAR, W, B, cols, cmask, eps)
        x = tl.load(X + off, mask=m, other=0.0).to(tl.float32)
        dy = tl.load(DY + off, mask=m, other=0.0).to(tl.float32)
        g = _through_relu_t(x, dy, MASK, off, m, mean, mul, bias, RELU, SAVED)
        if TRAIN:
            # per channel, once a program: Σg / n and rstd · dweight / n (0
            # where the raw variance was clamped)
            count = tl.load(COUNT + cols * 0)
            mean_g = tl.math.div_rn(tl.load(D + cols, mask=cmask, other=0.0), count)
            k = tl.math.div_rn(tl.load(D + C + cols, mask=cmask, other=0.0), count) * rstd
            k = tl.where(tl.load(VAR + cols, mask=cmask, other=0.0) >= 0, k, 0.0)
            dx = mul[None, :] * (g - mean_g[None, :] - (x - mean[None, :]) * k[None, :])
        else:
            dx = mul[None, :] * g
        tl.store(DX + off, dx.to(DX.dtype.element_ty), mask=m)
        if RES:
            tl.store(DR + off, g.to(DR.dtype.element_ty), mask=m)

    _KERNELS = dict(triton=triton, stats=_bn_stats_kernel, moments=_bn_moments_kernel,
                    apply=_bn_apply_kernel, grad_sums=_bn_grad_sums_kernel,
                    grad_reduce=_bn_grad_reduce_kernel, dx=_bn_dx_kernel)
    return _KERNELS


def _tile(c: int) -> Tuple[int, int]:
    """(BLOCK_C, ROWS): up to 128 channels (256 contiguous bytes of bf16) by
    enough rows for a TILE-element tile."""
    block_c = min(1 << max(c - 1, 0).bit_length(), 128)
    return block_c, max(1, TILE // block_c)


def _runs(m: int, c: int, device) -> Tuple[int, int, int, int]:
    """(BLOCK_C, ROWS, rows a program, programs down the rows) for a
    run-of-rows kernel: PROGRAMS_PER_SM programs an SM over the channel
    blocks, each a run of rows that is a multiple of ROWS."""
    block_c, rows = _tile(c)
    c_blocks = -(-c // block_c)
    programs = max(1, PROGRAMS_PER_SM * sm_count(device) // c_blocks)
    per_prog = -(-(-(-m // programs)) // rows) * rows
    return block_c, rows, per_prog, -(-m // per_prog)


def _grid(m: int, c: int):
    block_c, rows = _tile(c)
    return (-(-m // rows), -(-c // block_c)), block_c, rows


def bn_stats(x2, running_mean, running_var, momentum: float, mesh=None):
    """(st, new running mean, new running var) of [M, C] rows; ``st`` is
    fp32 ``[mean (C), raw var (C), M (1)]``, over the slice's rows with a
    ``mesh`` (its sums and count all-reduced over ``data``)."""
    if not on_card(x2, "batch norm"):
        return bn_stats_plain(x2, running_mean, running_var, momentum, mesh)
    k = _kernels()
    m, c = x2.shape
    block_c, rows, per_prog, parts = _runs(m, c, x2.device)
    part = torch.empty((parts, 2 * c), device=x2.device, dtype=torch.float32)
    k["stats"][(parts, -(-c // block_c))](x2, part, m, c, per_prog, ROWS=rows,
                                          BLOCK_C=block_c, num_warps=4)
    st = torch.empty(2 * c + 1, device=x2.device, dtype=torch.float32)
    new_mean, new_var = torch.empty_like(running_mean), torch.empty_like(running_var)
    moments = lambda part, parts, out, final: k["moments"][(-(-c // 32),)](
        part, parts, float(m), running_mean, running_var, out, new_mean, new_var, c,
        momentum, 1 - momentum, FINAL=final, COUNT_IN=final and mesh is not None,
        BLOCK_P=64, BLOCK_C=32, num_warps=4)
    if mesh is not None:  # this rank's [Σx, Σx², M], summed over the slice
        sums = torch.empty_like(st)
        moments(part, parts, sums, False)
        part, parts = _slice_sum(sums, mesh), 1
    moments(part, parts, st, True)
    bn_stats.launches += 1
    return st, new_mean, new_var


def bn_apply(x2, mean, var, weight, bias, eps: float, relu: bool, residual=None,
             out_dtype=torch.float32, with_mask: bool = False):
    """(y [M, C] in ``out_dtype``, uint8 ReLU mask or None): the normalise
    pass and its epilogue."""
    if not on_card(x2, "batch norm"):
        return bn_apply_plain(x2, mean, var, weight, bias, eps, relu, residual,
                              out_dtype, with_mask)
    k = _kernels()
    m, c = x2.shape
    y = torch.empty((m, c), device=x2.device, dtype=out_dtype)
    mask = (torch.empty((m, c), device=x2.device, dtype=torch.uint8)
            if with_mask else None)
    grid, block_c, rows = _grid(m, c)
    k["apply"][grid](x2, mean, var, weight, bias,
                     x2 if residual is None else residual, y,
                     y if mask is None else mask, m, c, float(eps),
                     RELU=relu, RES=residual is not None, SAVE_MASK=with_mask,
                     ROWS=rows, BLOCK_C=block_c, num_warps=4)
    bn_apply.launches += 1
    return y, mask


def bn_grad_sums(x2, dy, mask, mean, var, weight, bias, eps: float, relu: bool):
    """fp32 ``[dbias (C), dweight (C)]`` of this rank's rows."""
    if not on_card(x2, "batch norm"):
        return bn_grad_sums_plain(x2, dy, mask, mean, var, weight, bias, eps, relu)
    k = _kernels()
    m, c = x2.shape
    block_c, rows, per_prog, parts = _runs(m, c, x2.device)
    part = torch.empty((parts, 2 * c), device=x2.device, dtype=torch.float32)
    k["grad_sums"][(parts, -(-c // block_c))](
        x2, dy, x2 if mask is None else mask, mean, var, weight, bias, part, m, c,
        per_prog, float(eps), RELU=relu, SAVED=mask is not None, ROWS=rows,
        BLOCK_C=block_c, num_warps=4)
    d = torch.empty(2 * c, device=x2.device, dtype=torch.float32)
    k["grad_reduce"][(-(-c // 32),)](part, parts, var, d, c, float(eps),
                                     BLOCK_P=64, BLOCK_C=32, num_warps=4)
    bn_grad_sums.launches += 1
    return d


def bn_dx(x2, dy, mask, mean, var, count, weight, bias, d, eps: float, relu: bool,
          residual_dtype=None):
    """(dx [M, C] in x's dtype, the residual's gradient or None)."""
    if not on_card(x2, "batch norm"):
        return bn_dx_plain(x2, dy, mask, mean, var, count, weight, bias, d, eps,
                           relu, residual_dtype)
    k = _kernels()
    m, c = x2.shape
    dx = torch.empty_like(x2)
    dr = (None if residual_dtype is None
          else torch.empty((m, c), device=x2.device, dtype=residual_dtype))
    grid, block_c, rows = _grid(m, c)
    k["dx"][grid](x2, dy, x2 if mask is None else mask, mean, var,
                  mean if count is None else count, weight, bias, d, dx,
                  dx if dr is None else dr, m, c, float(eps), RELU=relu,
                  SAVED=mask is not None, TRAIN=count is not None,
                  RES=dr is not None, ROWS=rows, BLOCK_C=block_c, num_warps=4)
    bn_dx.launches += 1
    return dx, dr


bn_stats.launches = 0
bn_apply.launches = 0
bn_grad_sums.launches = 0
bn_dx.launches = 0
WRAPPERS = (bn_stats, bn_apply, bn_grad_sums, bn_dx)


# ----------------------------------------------------------------- public op


class _BatchNorm(torch.autograd.Function):
    """The normalise pass and its hand-derived backward. The statistics come
    in computed (``count`` is None in eval mode, where they take no
    gradient); the backward saves x (its dtype), the per-channel statistics
    and the one-byte mask of a residual ReLU."""

    @staticmethod
    def forward(ctx, x2, weight, bias, r2, mean, var, count, eps, relu, out_dtype, mesh):
        with_mask = relu and r2 is not None
        y, mask = bn_apply(x2, mean, var, weight, bias, eps, relu, r2, out_dtype,
                           with_mask)
        ctx.save_for_backward(x2, mask, mean, var, count, weight, bias)
        ctx.eps, ctx.relu, ctx.mesh = eps, relu, mesh
        ctx.residual_dtype = None if r2 is None else r2.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, mask, mean, var, count, weight, bias = ctx.saved_tensors
        with region("norm"):
            dy = dy.contiguous()
            d = bn_grad_sums(x2, dy, mask, mean, var, weight, bias, ctx.eps, ctx.relu)
            # the statistics are the slice's: their cotangent sums over it
            total = d if count is None else _slice_sum(d, ctx.mesh)
            dx, dr = bn_dx(x2, dy, mask, mean, var, count, weight, bias, total,
                           ctx.eps, ctx.relu, ctx.residual_dtype)
        c = weight.shape[0]
        # dweight and dbias: this rank's rows' part, as the parameters' own
        return dx, d[c:], d[:c], dr, None, None, None, None, None, None, None


def _rows(t: torch.Tensor, c: int, name: str) -> torch.Tensor:
    """``t`` as [M, C] rows without a copy: a contiguous [M, C], or a
    channels-last [N, C, H, W]."""
    if t.dim() not in (2, 4) or t.shape[1] != c:
        raise ValueError(f"{name}: expected [M, {c}] or [N, {c}, H, W], got "
                         f"{tuple(t.shape)}")
    if t.dim() == 2:
        if not t.is_contiguous():
            raise ValueError(f"{name}: [M, C] rows must be contiguous")
        return t
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: a 4-D input must be channels-last, got strides "
                         f"{t.stride()}")
    return t.permute(0, 2, 3, 1).reshape(-1, c)


def _check_vec(name: str, t: torch.Tensor, c: int) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != (c,) or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous fp32 ({c},), got "
                         f"{t.dtype} {tuple(t.shape)}")


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, *,
               train: bool, momentum: float, eps: float, relu: bool = False,
               residual: Optional[torch.Tensor] = None, out_dtype=torch.float32,
               mesh=None):
    """``[ReLU]([residual +] batch_norm(x))`` in ``out_dtype``, and the new
    running statistics (in eval mode the ones given).

    ``x`` is [M, C] rows or a channels-last [N, C, H, W] (any float dtype;
    the statistics and the normalisation are fp32); ``residual`` has its
    shape and layout. With a ``mesh`` (a slice whose ``data`` axis splits
    the rows) the statistics are the slice's. Without autograd (no grad
    mode, or nothing requiring grad) only the normalise pass runs."""
    c = weight.shape[0]
    x2 = _rows(x, c, "x")
    r2 = None
    if residual is not None:
        if residual.shape != x.shape:
            raise ValueError(f"residual: shape {tuple(residual.shape)} is not x's "
                             f"{tuple(x.shape)}")
        r2 = _rows(residual, c, "residual")
    for name, t in (("weight", weight), ("bias", bias), ("running_mean", running_mean),
                    ("running_var", running_var)):
        _check_vec(name, t, c)
    if train:
        st, new_mean, new_var = bn_stats(x2.detach(), running_mean, running_var,
                                         momentum, mesh)
        mean, var, count = st[:c], st[c:2 * c], st[2 * c:]
    else:
        mean, var, count = running_mean, running_var, None
        new_mean, new_var = running_mean, running_var
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias, residual)):
        y2 = _BatchNorm.apply(x2, weight, bias, r2, mean, var, count, float(eps),
                              relu, out_dtype, mesh)
    else:
        y2, _ = bn_apply(x2, mean, var, weight, bias, float(eps), relu, r2, out_dtype)
    if x.dim() == 4:
        n, _, h, w = x.shape
        y2 = y2.view(n, h, w, c).permute(0, 3, 1, 2)
    return y2, new_mean, new_var
