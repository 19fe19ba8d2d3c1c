#!/usr/bin/env python3
"""Quickest proof that the PyTorch/H100 port runs on the card.

    python3 chip_smoke.py            # every phase, one CUDA card

Phases (any failure exits non-zero):

1. device     the card's name, power limit and maximum SM clock
              (nvidia-smi); TF32 off for every comparison (matmul and cuDNN).
2. build      nvcc builds the CUDA kernels from ``dedloc_tpu_torch/ops/csrc``
              (timed); registers and spill bytes per kernel from ptxas;
              Triton kernels build at their first launch.
3. kernels    every kernel of the training paths against its plain PyTorch
              version on the same inputs at the paths' shapes: flash
              [12, 512, 16, 64] bf16 with two short samples and one
              all-padding sample, and flash [2, 16384, 16, 64] bf16 (one
              sample with every key, one with keys from 12,288 on masked;
              its plain versions run one head at a time: [B, H, S, S] fp32
              is 17 GB per tensor); two launches of each flash kernel
              bitwise equal at both shapes; add+LN [6144, 1024] bf16; plus
              ragged cases at the tile edges (S=100, 200 and 16,320 at
              D=64, S=200 at D=128), every other supported head dim at
              S=130, and peaked attention at S=16,384 (q x 4: scores of
              standard deviation 4). The flash tolerance scales with each
              sample's own max |ref|; the mean signed error toward |ref|
              shows a bias that the tolerance would pass. Device time per
              call (CUDA-graph replays between CUDA events, median) of the
              kernel, the plain version and, where one exists, the one
              PyTorch call computing the same function (timed only, never
              used by the port).
4. reference  the tiny config on the card (kernels) against the same
              weights and batch on the CPU (plain versions).
5. path       ALBERT-large (24 x 1024, 16 heads), micro-batch 12 x 512,
              accumulation 2, LAMB with warmup 0, remat policy fused_ln:
              3 optimizer steps through build_model / build_optimizer /
              synthetic_mlm_batches / make_accumulate_step /
              make_apply_step, every launch counter reset just before and
              checked just after (48/48/48/96/96 per step); one more step
              under torch.profiler (device busy time, idle share); then the
              same 3 steps without remat, for time and peak memory.
6. longctx    ALBERT-large at S=16,384 (max_position_embeddings 16,384,
              flash, remat policy dots_no_batch_attn, as the JAX package's
              long-context bench builds it), micro-batch 1, accumulation 2,
              LAMB with warmup 0: 3 optimizer steps with the counters reset
              and checked (48/48/48/0/0 per step); 2 steps without remat,
              whose peak memory must be higher; one step under
              torch.profiler. Then a witness that runs no kernel: the same
              weights and batches for 2 steps with attention_impl=
              "blockwise" (plain PyTorch, 0 launches); the flash run's
              losses before the first update must agree with it.
7. collab     the collaborative boundary. On ALBERT-large's gradients (one
              accumulation of 2 x 12 x 512 on the card): the device-flat
              pipeline's wire (fp32, fp16, uint8) and error-feedback
              residual against the same pipeline on the CPU (fp32, fp16
              bitwise; uint8 within one code, its lo and scale bitwise);
              the flat LAMB apply against the per-leaf guarded apply over 3
              steps (1e-6 relative), two flat runs bitwise equal, a NaN
              gradient rolled back bitwise with ok False. Then two trainer
              peers as subprocesses through the real CLI
              (``python -m dedloc_tpu_torch.roles.trainer``, ALBERT-large,
              12 x 512, accumulation 2, remat fused_ln, target batch 48,
              fp16 wire, device-flat, flat apply, error feedback), peer B
              joining through peer A's DHT address, stopped once both have
              taken 4 averaged global steps in groups of 2: every averaged
              step took the flat apply and sent 2 bytes per gradient
              element, no fallback fired, each boundary launched
              48/48/48/96/96 kernels, the losses are finite, and the two
              peers' checkpointed states hash equal at their last common
              step. Each peer's step phases come from its telemetry event
              log (StepRecorder).

Prints a ``{"build": ...}`` line, a ``{"kernels": [...]}`` line, a
``{"path": ...}`` line, a ``{"longctx": ...}`` line, a ``{"collab": ...}``
line, the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): the bounds below are
# arithmetic on this run's shapes, not measurements
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# exp2 results per clock per SM (the special-function units, sm_90); with
# the SM count and maximum clock read from this card it bounds the exps of
# an attention kernel (one per score)
MUFU_PER_CLOCK = 16
EXP_PER_S = 0.0  # set by phase_device

FLASH_SHAPE = (12, 512, 16, 64)  # B, S, H, D of the S=512 path
LONG_SEQ = 16384
LONG_SHAPE = (2, LONG_SEQ, 16, 64)  # the long-context path's length
# |flash - blockwise| allowed on the long-context losses before the first
# update. The two differ only in attention's rounding (p rounded to bf16
# against different running maxima). The MLM term averages 2,461 positions
# and moved 1e-5 between them; the SOP term is one sample's at B=1 and
# moved 1e-3 (PERF.md, Findings). A wrong tile, mask or scale, or a bias
# in every row, moves the MLM term by far more than its limit.
WITNESS_MLM_TOL = 1e-4
WITNESS_LOSS_TOL = 5e-3
LN_ROWS, LN_WIDTH = 12 * 512, 1024
FLASH_SRC = "dedloc_tpu_torch/ops/csrc/flash_attention.cu"
LN_SRC = "dedloc_tpu_torch/ops/fused_ln.py"
FLASH_PY = "dedloc_tpu/ops/flash_attention.py"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, reps: int = 25, calls: int = 10) -> float:
    """Device time of one call: ``calls`` calls captured in a CUDA graph
    (so host launch overhead is out of the measurement), the graph replayed
    ``reps`` times between CUDA events after warm-up; median per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up (Triton builds, allocator) off the graph
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) / calls


def event_ms(fn, reps: int = 3) -> float:
    """Median time of one call between CUDA events (host launch overhead
    included): for calls too large to capture in a graph."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, **ops_ms: float) -> dict:
    """The least time the card could take: the bytes over the HBM rate, or
    each kind of operation over its unit's peak (``ops_ms``, by unit),
    whichever is largest."""
    parts = {"hbm": n_bytes / HBM_BYTES_PER_S * 1e3, **ops_ms}
    unit = max(parts, key=parts.get)
    return dict(bound_ms=parts[unit],
                bound_by="bytes" if unit == "hbm" else "operations",
                binding_unit=unit, bound_parts_ms=parts)


def attention_bound(n_bytes: float, products: int, mm: float, n_exp: float):
    """Flash bound: bytes, ``products`` S x S x D matmuls of ``mm``
    operations each on the bf16 tensor cores, ``n_exp`` exponentials."""
    return bound(n_bytes, tensor_cores=products * mm / BF16_FLOPS * 1e3,
                 mufu_exp=n_exp / EXP_PER_S * 1e3)


def check_close(name: str, got, want, atol, rtol: float) -> float:
    """|got - want| <= atol + rtol * |want| everywhere; returns max abs err.
    ``atol`` is a number or a tensor that broadcasts against ``want``."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    err = (got - want).abs()
    worst = float(err.max())
    if torch.is_tensor(atol):
        atol_s = f"{float(atol.min()):.1e}..{float(atol.max()):.1e} per sample"
    else:
        atol_s = f"{atol:.1e}"
    if not bool((err <= atol + rtol * want.abs()).all()):
        fail(f"{name}: max abs err {worst:.3e} beyond atol {atol_s} + "
             f"rtol {rtol:.1e} * |ref|")
    log(f"  {name}: max abs err {worst:.3e} (atol {atol_s}, rtol {rtol:.1e})")
    return worst


def check_per_sample(name: str, got, want, real) -> dict:
    """check_close with atol 1e-2 x max|ref| of each sample (dim 0) and
    rtol 1e-2. An all-padding sample's gradients are hundreds of times a
    real sample's (p = exp(s - lse) is 1 for every key once -1e9 swallows
    log(l) in fp32, as in the reference), so one atol for the batch would
    leave the real samples unchecked. Returns the max abs err over all
    samples and, over the samples with keys (``real``, bool [B]), the max
    abs err, the max and mean |ref|, and the mean signed error toward |ref|
    (mean of (got - ref) * sign(ref): negative if got shrinks toward 0), a
    bias far below the tolerance that still moves every row one way."""
    ref = want.float().abs()
    atol = 1e-2 * ref.amax(dim=tuple(range(1, ref.dim())), keepdim=True)
    worst = check_close(name, got, want, atol, 1e-2)
    diff = (got.float() - want.float())[real]
    stats = dict(max_abs_err=float(diff.abs().max()), max_abs_ref=float(ref[real].max()),
                 mean_abs_ref=float(ref[real].mean()),
                 mean_signed_err=float((diff * want.float()[real].sign()).mean()))
    log(f"    samples with keys: max abs err {stats['max_abs_err']:.3e}, "
        f"max |ref| {stats['max_abs_ref']:.3e}, mean |ref| "
        f"{stats['mean_abs_ref']:.3e}, mean signed err {stats['mean_signed_err']:.3e}")
    return dict(all=worst, real=stats)


# --------------------------------------------------------------- phase 1-2


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device() -> str:
    global EXP_PER_S
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi("name,power.limit")
    max_mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    EXP_PER_S = MUFU_PER_CLOCK * sms * max_mhz * 1e6
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"{sms} SMs, max SM clock {max_mhz:.0f} MHz | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def phase_build() -> tuple:
    """Builds the CUDA kernels; returns the seconds it took and, per kernel
    instance (``flash_bwd_dq_kernel<64>``), the registers a thread is
    launched with and the bytes ptxas spills (stores)."""
    from dedloc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build("flash_attention")
    seconds = time.perf_counter() - t0
    log(f"[build] nvcc flash_attention.cu: {seconds:.1f} s")
    # one line per kernel instance: registers and spills (ptxas -v); and
    # any ptxas warning (a serialised wgmma pipeline says so there)
    name, spill_bytes, regs = "?", 0, {}
    for line in _build.build_log("flash_attention").splitlines():
        entry = re.search(r"Compiling entry function '.*?(flash_[a-z_]+_kernel)ILi(\d+)E",
                          line)
        if entry:
            name = f"{entry.group(1)}<{entry.group(2)}>"
        elif "spill stores" in line:
            spill_bytes = int(re.search(r"(\d+) bytes spill stores", line).group(1))
            log(f"  {name}: {line.strip()}")
        elif "Used" in line and "registers" in line:
            n = int(re.search(r"Used (\d+) registers", line).group(1))
            regs[name] = dict(registers=n, spill_bytes=spill_bytes)
            log(f"  {name}: {n} registers")
        elif "warning" in line.lower():
            log(f"  ptxas: {line.strip()}")
    return seconds, regs


# ----------------------------------------------------------------- phase 3


def _flash_inputs(b, s, h, d, gen, lengths):
    shape = (b, s, h, d)
    q, k, v, dout = (
        torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        for _ in range(4)
    )
    mask = torch.ones((b, s), device="cuda")
    for i, n in enumerate(lengths):
        mask[i, n:] = 0.0
    bias = torch.where(mask > 0, 0.0, -1e9).to(torch.float32)
    return q, k, v, dout, bias


def by_heads(fn, group: int, *args):
    """A plain flash function run ``group`` heads at a time (heads are
    independent), its results joined: [B, S, H, D] tensors along H, [B*H, S]
    row tensors (lse, delta) by head; the [B, S] bias goes whole."""
    b, _, h, _ = args[0].shape

    def cut(t, heads):
        if t.dim() == 4:
            return t[:, :, heads]
        if t.shape[0] == b * h:
            return t.reshape(b, h, -1)[:, heads].reshape(-1, t.shape[-1])
        return t

    def join(parts):
        if parts[0].dim() == 4:
            return torch.cat(parts, dim=2)
        rows = [p.reshape(b, -1, p.shape[-1]) for p in parts]
        return torch.cat(rows, dim=1).reshape(b * h, -1)

    results = [fn(*(cut(a, slice(h0, h0 + group)) for a in args))
               for h0 in range(0, h, group)]
    if isinstance(results[0], tuple):
        return tuple(join(list(r)) for r in zip(*results))
    return join(results)


def _check_flash(tag, q, k, v, dout, bias, group=None) -> dict:
    """Every flash kernel against its plain version (run ``group`` heads at
    a time when given); per kernel, the max abs err over the batch and, per
    output, the samples-with-keys statistics."""
    from dedloc_tpu_torch.ops import flash_attention as fa

    plain = (lambda fn, *a: by_heads(fn, group, *a)) if group else (
        lambda fn, *a: fn(*a))
    real = bias.amax(dim=1) == 0  # samples with at least one key
    out, lse = fa.flash_fwd(q, k, v, bias)
    out_p, lse_p = plain(fa.flash_fwd_plain, q, k, v, bias)
    o = check_per_sample(f"{tag} flash_fwd out", out, out_p, real)
    check_close(f"{tag} flash_fwd lse", lse, lse_p, 1e-3, 1e-5)
    del out_p, lse_p
    # the backward kernels on identical inputs (the kernel forward's lse)
    delta = fa.softmax_delta(out, dout)
    dk, dv = fa.flash_bwd_dkdv(q, k, v, bias, lse, dout, delta)
    dk_p, dv_p = plain(fa.flash_bwd_dkdv_plain, q, k, v, bias, lse, dout, delta)
    dq = fa.flash_bwd_dq(q, k, v, bias, lse, dout, delta)
    dq_p = plain(fa.flash_bwd_dq_plain, q, k, v, bias, lse, dout, delta)
    gk = check_per_sample(f"{tag} flash_bwd dk", dk, dk_p, real)
    gv = check_per_sample(f"{tag} flash_bwd dv", dv, dv_p, real)
    gq = check_per_sample(f"{tag} flash_bwd dq", dq, dq_p, real)
    # the autograd operator end to end, with a fixed random cotangent
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    grads = torch.autograd.grad(fa.flash_attention(qr, kr, vr, bias),
                                (qr, kr, vr), dout)
    for name, g, ref in zip(("dq", "dk", "dv"), grads, (dq_p, dk_p, dv_p)):
        check_per_sample(f"{tag} autograd {name}", g, ref, real)
    torch.cuda.synchronize()
    return {
        "flash_fwd": (o["all"], {"out": o["real"]}),
        "flash_bwd_dkdv": (max(gk["all"], gv["all"]),
                           {"dk": gk["real"], "dv": gv["real"]}),
        "flash_bwd_dq": (gq["all"], {"dq": gq["real"]}),
    }


def _check_repeat(tag, q, k, v, bias, lse, dout, delta) -> bool:
    """Two launches of each flash kernel on the same inputs give
    bitwise-equal outputs (every output row has one owner, no atomics)."""
    from dedloc_tpu_torch.ops import flash_attention as fa

    def launch():
        return (*fa.flash_fwd(q, k, v, bias),
                *fa.flash_bwd_dkdv(q, k, v, bias, lse, dout, delta),
                fa.flash_bwd_dq(q, k, v, bias, lse, dout, delta))

    first, second = launch(), launch()
    names = ("flash_fwd out", "flash_fwd lse", "flash_bwd dk", "flash_bwd dv",
             "flash_bwd dq")
    for name, a, b in zip(names, first, second):
        if not torch.equal(a, b):
            fail(f"{tag} {name}: two launches differ "
                 f"(max {float((a.float() - b.float()).abs().max()):.3e})")
    log(f"  {tag} flash_fwd out, lse and flash_bwd dk, dv, dq: two launches "
        f"bitwise equal")
    return True


def _flash_rows(path: str, shape, lengths, gen, replaces: dict,
                group=None, sdpa_backends=None, reps=25, calls=10) -> list:
    """The three flash kernels at ``shape``: checked against their plain
    versions (``group`` heads at a time when given), then timed beside
    their bounds, their plain versions and SDPA (restricted to
    ``sdpa_backends`` when given). One row per kernel."""
    import torch.nn.functional as F

    from dedloc_tpu_torch.ops import flash_attention as fa

    b, s, h, d = shape
    q, k, v, dout, bias = _flash_inputs(b, s, h, d, gen, lengths)
    log(f"[kernels] flash attention at {list(shape)} bf16, keys per sample "
        f"{lengths}, grids ({b * h}, {-(-s // fa.FWD_TILE)}) of {fa.FWD_TILE}-row "
        f"tiles (forward) and ({b * h}, {-(-s // fa.BWD_TILE)}) of "
        f"{fa.BWD_TILE}-row tiles (backward)")
    errs = _check_flash(f"S={s}", q, k, v, dout, bias, group)
    out, lse = fa.flash_fwd(q, k, v, bias)
    delta = fa.softmax_delta(out, dout)
    bitwise = _check_repeat(f"S={s}", q, k, v, bias, lse, dout, delta)
    # the library yardstick: SDPA with the same float mask ([B, H, S, D] views)
    qh, kh, vh, doh = (t.transpose(1, 2) for t in (q, k, v, dout))
    mask = bias.to(torch.bfloat16)[:, None, None, :]
    qg, kg, vg = (t.detach().requires_grad_() for t in (qh, kh, vh))

    def sdpa(fn):
        if sdpa_backends is None:
            return fn()
        from torch.nn.attention import sdpa_kernel
        with sdpa_kernel(sdpa_backends):
            return fn()

    lib_fwd = lambda: sdpa(
        lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    lib_fwd_bwd = lambda: sdpa(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask),
        (qg, kg, vg), doh))
    try:  # a yardstick only: a shape SDPA refuses leaves it untimed
        lib_fwd_ms = cuda_ms(lib_fwd, reps, calls)
        # its backward alone: forward+backward captured together, less the
        # forward
        lib_bwd_ms = cuda_ms(lib_fwd_bwd, reps, calls) - lib_fwd_ms
    except RuntimeError as e:
        log(f"  SDPA not timed at {list(shape)}: {e}")
        lib_fwd_ms = lib_bwd_ms = None
    if group:  # the plain versions one head group at a time, between events
        plain_ms = lambda fn, *a: event_ms(lambda: by_heads(fn, group, *a))
        plain_timing = f"CUDA events around the loop over {h // group} head groups"
    else:
        plain_ms = lambda fn, *a: cuda_ms(lambda: fn(*a), reps, calls)
        plain_timing = "CUDA graph"
    io = b * s * h * d * 2  # one bf16 [B, S, H, D] tensor
    rows = b * h * s * 4  # one fp32 [B*H, S] row tensor (lse, delta)
    mm = 2 * b * h * s * s * d  # one S x S x D matmul, in operations
    n_exp = b * h * s * s  # one exp per score, in every kernel
    tol = "atol 1e-2 max|ref[b]| for each sample b + rtol 1e-2 |ref|"
    common = dict(route="cuda", source=FLASH_SRC, path=path, shape=list(shape),
                  tol=tol, plain_timing=plain_timing)
    bwd = dict(bitwise_repeat=bitwise, **common)
    lib_bwd = dict(library_ms=lib_bwd_ms,
                   library="SDPA autograd backward, dq+dk+dv (fwd+bwd less fwd)")
    # the fused single-tile backward (the S=512 rows' TPU kernel) reads q, k,
    # v, dO, lse, delta and the bias, writes dq, dk, dv, and needs 5
    # products; the split pair recomputes s and dp, so each of its bounds
    # counts its own 4 or 3
    fused = attention_bound(7 * io + 2 * rows + b * s * 4, 5, mm, n_exp)
    result = [
        dict(name="flash_fwd", replaces=replaces["flash_fwd"],
             err=errs["flash_fwd"],
             ms=cuda_ms(lambda: fa.flash_fwd(q, k, v, bias), reps, calls),
             plain_ms=plain_ms(fa.flash_fwd_plain, q, k, v, bias),
             **attention_bound(4 * io + b * s * 4 + rows, 2, mm, n_exp),
             tensor_flops=2 * mm, library_ms=lib_fwd_ms, library="F.scaled_dot_product_attention",
             bitwise_repeat=bitwise, **common),
        dict(name="flash_bwd_dkdv", replaces=replaces["flash_bwd_dkdv"],
             err=errs["flash_bwd_dkdv"],
             ms=cuda_ms(lambda: fa.flash_bwd_dkdv(q, k, v, bias, lse, dout, delta),
                        reps, calls),
             plain_ms=plain_ms(fa.flash_bwd_dkdv_plain, q, k, v, bias, lse,
                               dout, delta),
             **attention_bound(6 * io + 2 * rows + b * s * 4, 4, mm, n_exp),
             tensor_flops=4 * mm, fused_bwd_bound_ms=fused["bound_ms"], **lib_bwd,
             **bwd),
        dict(name="flash_bwd_dq", replaces=replaces["flash_bwd_dq"],
             err=errs["flash_bwd_dq"],
             ms=cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, bias, lse, dout, delta),
                        reps, calls),
             plain_ms=plain_ms(fa.flash_bwd_dq_plain, q, k, v, bias, lse,
                               dout, delta),
             **attention_bound(5 * io + 2 * rows + b * s * 4, 3, mm, n_exp),
             tensor_flops=3 * mm, fused_bwd_bound_ms=fused["bound_ms"], **lib_bwd,
             **bwd),
    ]
    del q, k, v, dout, out, lse, delta, qg, kg, vg
    torch.cuda.synchronize()
    return result


def phase_kernels(seed: int) -> list:
    from torch.nn.attention import SDPBackend

    from dedloc_tpu_torch.ops import flash_attention as fa
    from dedloc_tpu_torch.ops import fused_ln as fl

    gen = torch.Generator(device="cuda").manual_seed(seed)
    fused = f"{FLASH_PY}:262"  # _dqkv_fused_kernel: S fits one tile
    # S=512: samples 0 and 1 end early, sample 2 is all padding (uniform
    # average of V, as the TPU kernel)
    results = _flash_rows(
        "S=512", FLASH_SHAPE, [300, 437, 0], gen,
        {"flash_fwd": f"{FLASH_PY}:61", "flash_bwd_dkdv": fused,
         "flash_bwd_dq": fused})
    gc.collect()
    torch.cuda.empty_cache()
    # S=16,384: the JAX package's split backward (_dkv_kernel, _dq_kernel);
    # sample 0 keeps every key, sample 1 masks keys 12,288 on. SDPA without
    # its math backend, which would materialise the scores
    results += _flash_rows(
        f"S={LONG_SEQ}", LONG_SHAPE, [LONG_SEQ, 12288], gen,
        {"flash_fwd": f"{FLASH_PY}:61", "flash_bwd_dkdv": f"{FLASH_PY}:219",
         "flash_bwd_dq": f"{FLASH_PY}:182"},
        group=1, reps=5, calls=2,
        sdpa_backends=[SDPBackend.EFFICIENT_ATTENTION,
                       SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION])
    gc.collect()
    torch.cuda.empty_cache()

    # ragged tiles: S=100 is below one 128-row backward tile, S=200 ends
    # inside the second, S=16,320 is a multiple of 64 that ends half way
    # through the last 128-row tile
    log("[kernels] flash attention ragged S=100, 200, 16,320 (D=64), S=200 (D=128)")
    _check_flash("S=100 D=64", *_flash_inputs(2, 100, 16, 64, gen, [100, 37]))
    _check_flash("S=200 D=64", *_flash_inputs(2, 200, 16, 64, gen, [150, 0]))
    _check_flash("S=200 D=128", *_flash_inputs(2, 200, 8, 128, gen, [77]))
    _check_flash("S=16320 D=64", *_flash_inputs(2, 16320, 2, 64, gen, [16320, 9000]),
                 group=1)
    gc.collect()
    torch.cuda.empty_cache()
    # every other head dim the wrappers accept (each has its own swizzle and
    # wgmma N pieces), two rows into the second 128-row tile
    others = [d for d in fa.SUPPORTED_HEAD_DIMS if d not in (64, 128)]
    log(f"[kernels] flash attention S=130 at D={others}")
    for d in others:
        _check_flash(f"S=130 D={d}", *_flash_inputs(2, 130, 2, d, gen, [130, 61]))
    # peaked attention at the long-context length: q x 4 (exact in bf16)
    # gives scores of standard deviation 4, so a few keys carry each row
    log("[kernels] flash attention peaked (q x 4) at [1, 16384, 4, 64]")
    q, k, v, dout, bias = _flash_inputs(1, LONG_SEQ, 4, 64, gen, [LONG_SEQ])
    _check_flash("S=16384 peaked", q * 4, k, v, dout, bias, group=1)
    del q, k, v, dout, bias
    gc.collect()
    torch.cuda.empty_cache()

    # fused add+LayerNorm at the S=512 path's [B*S, hidden]
    log("[kernels] fused add+LN at [6144, 1024] bf16")
    n, w = LN_ROWS, LN_WIDTH
    x, r, dy = (torch.randn((n, w), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(3))
    gamma = 1.0 + 0.1 * torch.randn(w, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(w, generator=gen, device="cuda")
    eps = 1e-12
    y, xhat, rstd = fl.ln_fwd(x, r, gamma, beta, eps)
    y_p, xhat_p, rstd_p = fl.ln_fwd_plain(x, r, gamma, beta, eps)
    y_only, _, _ = fl.ln_fwd(x, r, gamma, beta, eps, with_residuals=False)
    fwd_err = max(
        check_close("ln_fwd y", y, y_p, 1e-2, 1e-2),
        check_close("ln_fwd xhat", xhat, xhat_p, 1e-2, 1e-2),
        check_close("ln_fwd y-only", y_only, y_p, 1e-2, 1e-2),
    )
    check_close("ln_fwd rstd", rstd, rstd_p, 0.0, 1e-5)
    da, dgamma, dbeta = fl.ln_bwd(xhat, rstd, gamma, dy)
    da_p, dgamma_p, dbeta_p = fl.ln_bwd_plain(xhat, rstd, gamma, dy)
    bwd_err = max(
        check_close("ln_bwd da", da, da_p, 1e-2, 1e-2),
        check_close("ln_bwd dgamma", dgamma, dgamma_p, 1e-2, 1e-4),
        check_close("ln_bwd dbeta", dbeta, dbeta_p, 1e-2, 1e-4),
    )
    log("[kernels] fused add+LN ragged width 1000")
    xs, rs = x[:256, :1000].contiguous(), r[:256, :1000].contiguous()
    ys, xhs, rss = fl.ln_fwd(xs, rs, gamma[:1000].contiguous(),
                             beta[:1000].contiguous(), eps)
    check_close("ln_fwd y (H=1000)", ys, fl.ln_fwd_plain(
        xs, rs, gamma[:1000], beta[:1000], eps)[0], 1e-2, 1e-2)
    dys = dy[:256, :1000].contiguous()
    check_close("ln_bwd da (H=1000)", fl.ln_bwd(xhs, rss, gamma[:1000].contiguous(), dys)[0],
                fl.ln_bwd_plain(xhs, rss, gamma[:1000], dys)[0], 1e-2, 1e-2)
    row = n * w * 2
    common = dict(route="triton", source=LN_SRC, path="S=512", shape=[n, w],
                  plain_timing="CUDA graph", library_ms=None, library=None)
    results.append(dict(
        name="ln_fwd", replaces="dedloc_tpu/ops/fused_ln.py:55",
        err=(fwd_err, None), tol="atol 1e-2 + rtol 1e-2 |ref|",
        ms=cuda_ms(lambda: fl.ln_fwd(x, r, gamma, beta, eps)),
        plain_ms=cuda_ms(lambda: fl.ln_fwd_plain(x, r, gamma, beta, eps)),
        **bound(4 * row + 2 * w * 4 + n * 4,
                fp32=10 * n * w / FP32_FLOPS * 1e3),
        **common,
    ))
    results.append(dict(
        name="ln_bwd", replaces="dedloc_tpu/ops/fused_ln.py:110",
        err=(bwd_err, None),
        tol="atol 1e-2 + rtol 1e-2 |ref| (dgamma, dbeta rtol 1e-4)",
        ms=cuda_ms(lambda: fl.ln_bwd(xhat, rstd, gamma, dy)),
        plain_ms=cuda_ms(lambda: fl.ln_bwd_plain(xhat, rstd, gamma, dy)),
        **bound(3 * row + n * 4 + 3 * w * 4,
                fp32=12 * n * w / FP32_FLOPS * 1e3),
        **common,
    ))
    torch.cuda.synchronize()
    return results


# ----------------------------------------------------------------- phase 4


def phase_reference(seed: int) -> None:
    """Tiny config, same weights and batch: card (kernels) vs CPU (plain)."""
    from dedloc_tpu_torch.roles.common import (
        build_loss_fn, build_model, drop_collator_keys, synthetic_mlm_batches,
    )

    log("[reference] tiny ALBERT (flash + fused_ln, bf16): card vs CPU")
    results = {}
    batch_np = None
    for device in ("cuda", "cpu"):
        cfg, model = build_model("tiny", remat_policy="fused_ln",
                                 attention_impl="flash", device=device,
                                 seed=seed)
        if batch_np is None:
            batch_np = next(synthetic_mlm_batches(cfg, 4, 64, seed))
            batch_np["attention_mask"][1, 40:] = 0  # one padded sample
        params = dict(model.named_parameters())
        loss, _ = build_loss_fn(model)(params, drop_collator_keys(batch_np, device))
        grads = torch.autograd.grad(loss, list(params.values()))
        results[device] = (float(loss.detach()), dict(zip(params, grads)))
    (loss_c, grads_c), (loss_p, grads_p) = results["cuda"], results["cpu"]
    log(f"  loss card {loss_c:.6f} cpu {loss_p:.6f}")
    if not math.isfinite(loss_c) or abs(loss_c - loss_p) > 2e-2:
        fail(f"tiny loss card {loss_c} vs cpu {loss_p} (tol 2e-2)")
    # per leaf: |card - cpu| <= 5e-2 (|cpu| + 0.02 x RMS leaf norm). The
    # floor covers leaves whose true gradient is ~0 (the key bias: softmax
    # ignores a per-row shift), where only rounding noise is left to compare
    rms = math.sqrt(sum(float(g.float().norm()) ** 2 for g in grads_p.values())
                    / len(grads_p))
    worst = 0.0
    for name, g in grads_c.items():
        ref = float(grads_p[name].float().norm())
        rel = float((g.float().cpu() - grads_p[name].float()).norm()) / (
            ref + 0.02 * rms)
        worst = max(worst, rel)
        if not rel <= 5e-2:
            fail(f"tiny grad {name}: |card - cpu| / (|cpu| + 0.02 rms) = "
                 f"{rel:.3e} > 5e-2 (|cpu| {ref:.3e}, rms {rms:.3e})")
    log(f"  {len(grads_c)} grads: worst |card - cpu| / (|cpu| + 0.02 rms) "
        f"{worst:.3e} (tol 5e-2)")


# ------------------------------------------------------------- phase 5-6


def run_path(tag: str, cfg, model, micro_batch: int, seq: int, seed: int,
             expected: dict, steps: int = 3, trace: str = "") -> dict:
    """``steps`` LAMB steps (accumulation 2, warmup 0) of ``model`` on
    synthetic MLM batches of ``micro_batch`` x ``seq``, every launch
    counter reset just before and read just after, each step's launches
    checked against ``expected``; then, with ``trace``, one more step under
    torch.profiler (not in the counts). The first step pays cuBLAS and
    allocator warm-up and is not timed."""
    from dedloc_tpu_torch.core.config import TrainingArguments
    from dedloc_tpu_torch.ops import flash_attention as fa
    from dedloc_tpu_torch.ops import fused_ln as fl
    from dedloc_tpu_torch.parallel.train_step import (
        TrainState, make_accumulate_step, make_apply_step, zeros_like_grads,
    )
    from dedloc_tpu_torch.roles.common import (
        build_loss_fn, build_optimizer, drop_collator_keys, synthetic_mlm_batches,
    )

    log(f"[{tag}] ALBERT-large, {micro_batch} x {seq}, accumulation 2, "
        f"{steps} LAMB steps, remat={cfg.remat} ({cfg.remat_policy}), "
        f"fused_ln={cfg.fused_ln}")
    args = TrainingArguments(model_size="large", remat_policy=cfg.remat_policy,
                             attention_impl=cfg.attention_impl, warmup_steps=0,
                             per_device_batch_size=micro_batch, seq_length=seq,
                             gradient_accumulation_steps=2, seed=seed)
    tx = build_optimizer(args)
    accumulate = make_accumulate_step(build_loss_fn(model))
    apply = make_apply_step(tx)
    params = dict(model.named_parameters())
    state = TrainState.create(params, tx)
    batches = synthetic_mlm_batches(cfg, micro_batch, seq, seed)
    wrappers = fa.WRAPPERS + fl.WRAPPERS
    losses, parts = [], []  # per micro-batch: loss, and its (MLM, SOP) terms

    def optimizer_step() -> None:
        nonlocal state
        grad_acc, n_acc = zeros_like_grads(params), 0
        for _ in range(args.gradient_accumulation_steps):
            batch = drop_collator_keys(next(batches), device="cuda")
            grad_acc, n_acc, metrics = accumulate(params, grad_acc, n_acc, batch)
            losses.append(metrics["loss"])
            parts.append((metrics["mlm_loss"], metrics["sop_loss"]))
        state = apply(state, {k: g / n_acc for k, g in grad_acc.items()})
        torch.cuda.synchronize()

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers:
        w.launches = 0
    step_s, per_step = [], []
    for _ in range(steps):
        before = {w.__name__: w.launches for w in wrappers}
        t0 = time.perf_counter()
        optimizer_step()
        step_s.append(time.perf_counter() - t0)
        per_step.append({w.__name__: w.launches - before[w.__name__]
                         for w in wrappers})
    launches = {w.__name__: w.launches for w in wrappers}
    peak = torch.cuda.max_memory_allocated()
    # one more step, traced, for where its time goes (not in the counts)
    profile = profile_step(optimizer_step, trace) if trace else None

    losses = [float(x) for x in losses]
    mlm_losses = [float(m) for m, _ in parts]
    sop_losses = [float(s) for _, s in parts]
    log(f"  losses {losses}")
    log(f"  MLM {mlm_losses}, SOP {sop_losses}")
    log(f"  launches per step {per_step}")
    log(f"  step ms {[round(t * 1e3, 2) for t in step_s]}, peak {peak} bytes")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{tag}: non-finite loss {losses}")
    at_init = math.log(cfg.vocab_size) + math.log(2)
    if abs(losses[0] - at_init) > 0.5:
        fail(f"{tag}: first loss {losses[0]:.4f} not within 0.5 of {at_init:.4f}")
    for counts in per_step:
        if counts != expected:
            fail(f"{tag}: launches per step {counts} != {expected}")
    if not all(torch.isfinite(p).all() for p in params.values()):
        fail(f"{tag}: non-finite parameters after the steps")
    if state.step != steps + (1 if trace else 0):
        fail(f"{tag}: state.step {state.step} != {steps + (1 if trace else 0)}")
    timed = step_s[1:]
    ms = statistics.median(timed) * 1e3
    samples = args.gradient_accumulation_steps * micro_batch
    return dict(
        steps=steps, micro_batch=micro_batch, seq_length=seq,
        grad_accum=args.gradient_accumulation_steps, remat=cfg.remat,
        remat_policy=cfg.remat_policy, fused_ln=cfg.fused_ln, losses=losses,
        mlm_losses=mlm_losses, sop_losses=sop_losses,
        first_loss_at_init=at_init, step_ms=[t * 1e3 for t in step_s],
        ms_per_step=ms, samples_per_s=samples / (ms / 1e3),
        tokens_per_s=samples * seq / (ms / 1e3),
        max_memory_allocated=peak, launches=launches,
        launches_per_step=per_step[-1], profile=profile,
    )


def _large(cfg, seed: int):
    """ALBERT-large of ``cfg`` with random weights from ``seed`` on the card
    (what ``build_model`` does, for configs it does not name)."""
    from dedloc_tpu_torch.models.albert import AlbertForPreTraining, init_weights

    model = AlbertForPreTraining(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to("cuda")


def phase_path(seed: int, micro_batch: int = 12, seq: int = 512) -> dict:
    from dedloc_tpu_torch.roles.common import build_model

    cfg, model = build_model("large", remat_policy="fused_ln",
                             attention_impl="flash", device="cuda", seed=seed)
    if not (cfg.attention_impl == "flash" and cfg.fused_ln and cfg.remat
            and cfg.hidden_size == 1024 and cfg.num_hidden_layers == 24
            and cfg.num_attention_heads == 16):
        fail(f"unexpected config {cfg}")
    expected = {"flash_fwd": 48, "flash_bwd_dkdv": 48, "flash_bwd_dq": 48,
                "ln_fwd": 96, "ln_bwd": 96}  # per optimizer step, accum 2
    remat = run_path("path", cfg, model, micro_batch, seq, seed, expected,
                     trace="path_step_trace.json")
    del model
    cfg = dataclasses.replace(cfg, remat=False)
    keep_all = run_path("path, no remat", cfg, _large(cfg, seed), micro_batch,
                        seq, seed, expected)
    return dict(remat, no_remat={k: keep_all[k] for k in (
        "ms_per_step", "samples_per_s", "step_ms", "max_memory_allocated",
        "losses", "mlm_losses", "sop_losses", "launches_per_step")})


def phase_longctx(seed: int, seq: int = LONG_SEQ) -> dict:
    """The JAX package's long-context bench configuration (``run_longctx``)
    as one trainer peer: micro-batch 1 x 16,384, accumulation 2."""
    from dedloc_tpu_torch.models.albert import AlbertConfig

    cfg = AlbertConfig.large(max_position_embeddings=seq, attention_impl="flash",
                             remat_policy="dots_no_batch_attn")
    if not (cfg.remat and not cfg.fused_ln and cfg.attention_block_size < seq):
        fail(f"unexpected config {cfg}")
    expected = {"flash_fwd": 48, "flash_bwd_dkdv": 48, "flash_bwd_dq": 48,
                "ln_fwd": 0, "ln_bwd": 0}
    remat = run_path("longctx", cfg, _large(cfg, seed), 1, seq, seed, expected,
                     trace="longctx_step_trace.json")
    cfg = dataclasses.replace(cfg, remat=False)
    keep_all = run_path("longctx, no remat", cfg, _large(cfg, seed), 1, seq,
                        seed, expected, steps=2)
    if not keep_all["max_memory_allocated"] > remat["max_memory_allocated"]:
        fail(f"longctx: peak memory without remat "
             f"{keep_all['max_memory_allocated']} is not above the remat "
             f"run's {remat['max_memory_allocated']}")
    # the witness: the same weights and batches with attention_impl=
    # "blockwise" (ring_attention.blockwise_attention, plain PyTorch: fp32
    # online softmax over 512-key blocks, p rounded to bf16 before p.V),
    # so no kernel launches; 2 steps. Before the first update the two runs
    # differ only in attention's rounding, so their losses must agree
    cfg = dataclasses.replace(cfg, remat=True, attention_impl="blockwise")
    witness = run_path("longctx, blockwise witness", cfg, _large(cfg, seed), 1,
                       seq, seed, {k: 0 for k in expected}, steps=2)
    for key, tol in (("mlm_losses", WITNESS_MLM_TOL), ("losses", WITNESS_LOSS_TOL)):
        ours, theirs = remat[key][:2], witness[key][:2]
        gap = max(abs(a - b) for a, b in zip(ours, theirs))
        log(f"  flash vs blockwise {key} before the first update: {gap:.3e} "
            f"(tol {tol:.0e})")
        if not gap <= tol:
            fail(f"longctx: flash {key} {ours} vs blockwise {theirs}: "
                 f"{gap:.3e} > {tol:.0e}")
    keep = ("ms_per_step", "tokens_per_s", "step_ms", "max_memory_allocated",
            "losses", "mlm_losses", "sop_losses", "launches_per_step")
    return dict(remat, no_remat={k: keep_all[k] for k in keep},
                blockwise_witness={k: witness[k] for k in keep})


# ----------------------------------------------------------------- phase 7

COLLAB_EXPECTED = {"flash_fwd": 48, "flash_bwd_dkdv": 48, "flash_bwd_dq": 48,
                   "ln_fwd": 96, "ln_bwd": 96}  # per boundary, as the path's
# the path phase's configuration, as trainer flags
COLLAB_MODEL_FLAGS = ["--training.model_size", "large",
                      "--training.remat_policy", "fused_ln",
                      "--training.attention_impl", "flash",
                      "--training.per_device_batch_size", "12",
                      "--training.seq_length", "512"]
COLLAB_STEPS = 4  # averaged global steps to wait for (at least 3 are checked)
COLLAB_MIN_STEPS = 3
COLLAB_DEADLINE_S = 240.0
FALLBACKS = ("falling back to the host flatten path",
             "keeping the per-leaf guarded apply")


def collab_card_checks(seed: int) -> dict:
    """The boundary's pieces on the card at ALBERT-large's gradients."""
    from dedloc_tpu_torch.averaging.device_flat import DeviceFlatPipeline
    from dedloc_tpu_torch.core.config import TrainingArguments
    from dedloc_tpu_torch.models.convert import state_views
    from dedloc_tpu_torch.parallel.train_step import (
        TrainState, make_accumulate_step, make_flat_apply_step,
        make_guarded_apply_step, zeros_like_grads,
    )
    from dedloc_tpu_torch.roles.common import (
        build_flat_opt_factory, build_loss_fn, build_model, build_optimizer,
        drop_collator_keys, synthetic_mlm_batches,
    )

    log("[collab] boundary checks on ALBERT-large's gradients")
    cfg, model = build_model("large", remat_policy="fused_ln",
                             attention_impl="flash", device="cuda", seed=seed)
    params = dict(model.named_parameters())
    accumulate = make_accumulate_step(build_loss_fn(model))
    batches = synthetic_mlm_batches(cfg, 12, 512, seed)
    grads, n = zeros_like_grads(params), 0
    for _ in range(2):
        grads, n, _ = accumulate(params, grads, n,
                                 drop_collator_keys(next(batches), device="cuda"))
    grads_cpu = {k: v.cpu() for k, v in grads.items()}
    total = sum(g.numel() for g in grads.values())
    out = {"flat_size": total, "wire": {}}
    flats = {}
    for comp in ("none", "float16", "uint8"):
        card = DeviceFlatPipeline.for_tree(grads, compression=comp)
        host = DeviceFlatPipeline.for_tree(grads_cpu, compression=comp)
        fc = card.fetch(grads, n=n, use_ef=True)
        fh = host.fetch(grads_cpu, n=n, use_ef=True)
        meta_c = [m.cpu() for m in fc._meta]
        meta_h = list(fh._meta)
        res_c = None if fc._new_residual is None else fc._new_residual.cpu()
        res_h = fh._new_residual
        a, b = fc.result().flat, fh.result().flat
        row = dict(wire_bytes=fc.wire_bytes,
                   bytes_per_element=fc.wire_bytes / total,
                   exposed_wait_ms=fc.exposed_wait_s * 1e3,
                   fetch_ms=event_ms(lambda: card.fetch(grads, n=n).result()))
        if comp == "uint8":
            for name, x, y in (("lo", meta_c[0], meta_h[0]),
                               ("scale", meta_c[1], meta_h[1])):
                if not torch.equal(x, y):
                    fail(f"collab: uint8 {name} card != cpu")
            scale = meta_h[1].numpy()
            codes = 0.0
            for i, (lo, hi) in enumerate(card.bounds):
                codes = max(codes, float(abs(a[lo:hi] - b[lo:hi]).max() / scale[i]))
            if not codes <= 1.0 + 1e-4:
                fail(f"collab: uint8 card vs cpu {codes:.3f} codes apart (tol 1)")
            row["max_codes_apart"] = codes
        else:
            if a.tobytes() != b.tobytes():
                fail(f"collab: {comp} wire card != cpu")
            if res_c is not None and not torch.equal(res_c, res_h):
                fail(f"collab: {comp} error-feedback residual card != cpu")
            row["bitwise"] = True
        flats[comp] = (card, a)
        out["wire"][comp] = row
        log(f"  {comp}: {json.dumps(row)}")
    if out["wire"]["float16"]["wire_bytes"] != 2 * total:
        fail("collab: the fp16 wire is not 2 bytes per element")

    # the flat apply against the per-leaf guarded apply, from one state and
    # on the same mean gradients (the fp32 wire is grads / n bitwise)
    targs = TrainingArguments(warmup_steps=0)
    tx = build_optimizer(targs)
    spec = flats["none"][0].spec
    flat_dev = torch.from_numpy(flats["none"][1]).cuda()
    mean = {k: g / n for k, g in grads.items()}
    init = {k: v.detach().clone() for k, v in params.items()}
    del model, params, grads
    fresh = lambda: TrainState.create({k: v.clone() for k, v in init.items()}, tx)
    flat_fn = make_flat_apply_step(build_flat_opt_factory(targs)(spec, init), spec)
    leaf_fn = make_guarded_apply_step(tx)
    sa, sb, sc = fresh(), fresh(), fresh()
    worst = 0.0
    for _ in range(3):
        sa, ok_a = flat_fn(sa, flat_dev)
        sb, ok_b = leaf_fn(sb, mean)
        sc, _ok = flat_fn(sc, flat_dev)
        if not (bool(ok_a) and bool(ok_b)):
            fail("collab: a finite apply reported ok False")
        for name, p in sb.params.items():
            rel = float((sa.params[name] - p).abs().max() / p.abs().max().clamp_min(1e-30))
            worst = max(worst, rel)
    moved = max(float((sa.params[k] - init[k]).abs().max()) for k in init)
    if not worst <= 1e-6:
        fail(f"collab: flat vs per-leaf apply {worst:.3e} relative (tol 1e-6)")
    if not moved > 0:
        fail("collab: 3 applies did not move the params")
    views = lambda st: state_views(st.params, st.opt_state, clip=True, schedule=True)
    for name, t in views(sa).items():
        if not torch.equal(t, views(sc)[name]):
            fail(f"collab: two flat applies differ at {name}")
    before = {k: v.clone() for k, v in views(sa).items()}
    poisoned = flat_dev.clone()
    poisoned[total // 2] = float("nan")
    sa, ok = flat_fn(sa, poisoned)
    if bool(ok):
        fail("collab: a NaN gradient gave ok True")
    for name, t in views(sa).items():
        if not torch.equal(t, before[name]):
            fail(f"collab: the NaN rollback changed {name}")
    out.update(
        flat_vs_leaf_rel_err=worst, max_param_move=moved,
        flat_apply_ms=event_ms(lambda: flat_fn(sc, flat_dev)),
        leaf_apply_ms=event_ms(lambda: leaf_fn(sb, mean)),
    )
    log(f"  flat vs per-leaf apply over 3 steps: {worst:.3e} relative (tol "
        f"1e-6); two flat runs bitwise; NaN rolled back bitwise; flat apply "
        f"{out['flat_apply_ms']:.2f} ms, per-leaf {out['leaf_apply_ms']:.2f} ms")
    return out


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _jsonl(path) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip().endswith("}")]


def _state_hash(path) -> str:
    from dedloc_tpu_torch.utils.checkpoint import load_checkpoint

    named, _meta = load_checkpoint(path)
    h = hashlib.sha256()
    for name in sorted(named):
        arr = named[name]
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _peer_report(peer: str, work: str, total: int) -> dict:
    """One peer's train log, event log and stderr log, checked."""
    records = _jsonl(os.path.join(work, "train.jsonl"))
    events = _jsonl(os.path.join(work, "events.jsonl"))
    with open(os.path.join(work, "log.txt")) as f:
        text = f.read()
    for marker in FALLBACKS:
        if marker in text:
            fail(f"collab: peer {peer} fell back: {marker!r}")
    joint = [r for r in records if r["group_size"] == 2]
    if len(joint) < COLLAB_MIN_STEPS:
        fail(f"collab: peer {peer} took {len(joint)} averaged steps "
             f"(want >= {COLLAB_MIN_STEPS}); log tail:\n{text[-3000:]}")
    for r in joint:
        if r["apply"] != "flat":
            fail(f"collab: peer {peer} step {r['step']} took the "
                 f"{r['apply']} apply")
    if not all(math.isfinite(r["loss"]) for r in records):
        fail(f"collab: peer {peer} non-finite loss")
    prev = {"boundaries": 0, "kernel_launches": {k: 0 for k in COLLAB_EXPECTED}}
    for r in records:
        nb = r["boundaries"] - prev["boundaries"]
        got = {k: r["kernel_launches"][k] - prev["kernel_launches"][k]
               for k in COLLAB_EXPECTED}
        if got != {k: v * nb for k, v in COLLAB_EXPECTED.items()}:
            fail(f"collab: peer {peer} launched {got} in {nb} boundaries "
                 f"(want {COLLAB_EXPECTED} each)")
        prev = r
    d2h = [e for e in events if e.get("event") == "opt.d2h_stream"]
    if not d2h or any(e["bytes"] != 2 * total or e["compression"] != "float16"
                      for e in d2h):
        fail(f"collab: peer {peer} d2h wire bytes "
             f"{sorted({e['bytes'] for e in d2h})} != 2 x {total}")
    steps = [e for e in events if e.get("event") == "step.record"]
    stepped = [e for e in steps if e.get("stepped")][1:]  # the first warms up
    plain = [e for e in steps if not e.get("stepped")][1:]
    med = lambda xs: statistics.median(xs) if xs else None
    phases = sorted({k for e in stepped for k in e.get("phases", {})})
    return dict(
        global_steps=[r["step"] for r in records],
        averaged_steps=[r["step"] for r in joint],
        solo_steps=[r["step"] for r in records if r["group_size"] == 1],
        losses=[r["loss"] for r in records],
        boundaries=records[-1]["boundaries"],
        kernel_launches=records[-1]["kernel_launches"],
        d2h_fetches=len(d2h), wire_bytes_per_round=d2h[-1]["bytes"],
        d2h_exposed_ms=[e["exposed_s"] * 1e3 for e in d2h],
        stepped_boundary_ms=med([e["dur_s"] * 1e3 for e in stepped]),
        other_boundary_ms=med([e["dur_s"] * 1e3 for e in plain]),
        phases_ms={k: med([e["phases"].get(k, 0.0) * 1e3 for e in stepped])
                   for k in phases},
        samples_per_s=statistics.mean(r["samples_per_second"] for r in joint),
        seam_ms=joint[-1]["seam_ms"],
        max_memory_allocated=records[-1].get("max_memory_allocated"),
    )


def collab_peers(seed: int, total: int) -> dict:
    """Two trainer peers on the one card through the CLI, started together,
    each bootstrapping its DHT from the other's address (so neither trains
    alone while the other starts); stopped (SIGINT) once both have taken
    COLLAB_STEPS averaged steps."""
    from dedloc_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="collab-", dir=_build.BUILD_DIR)
    ports = {"A": _free_port(), "B": _free_port()}
    cmd = [sys.executable, "-m", "dedloc_tpu_torch.roles.trainer",
           "--dht.experiment_prefix", "chip-smoke-collab",
           "--dht.listen_host", "127.0.0.1", *COLLAB_MODEL_FLAGS,
           "--training.gradient_accumulation_steps", "2",
           "--training.warmup_steps", "0", "--training.seed", str(seed),
           "--training.max_local_steps", "200",
           "--training.save_steps", "1", "--training.save_total_limit", "0",
           "--optimizer.target_batch_size", "48",
           "--optimizer.device_flat", "true", "--optimizer.flat_apply", "true",
           "--optimizer.error_feedback", "true",
           "--averager.compression", "float16",
           # a fresher view of the partner's progress than the 3 s default,
           # so a run of a few steps is not mostly waiting for the refresh
           "--averager.min_refresh_period", "0.2",
           "--averager.default_refresh_period", "0.5",
           "--telemetry.enabled", "true"]
    procs, logs = {}, {}
    t_start = time.perf_counter()
    try:
        for peer, other in (("A", "B"), ("B", "A")):
            pdir = os.path.join(work, peer)
            os.makedirs(pdir)
            logs[peer] = open(os.path.join(pdir, "log.txt"), "w")
            procs[peer] = subprocess.Popen(
                cmd + [
                    "--dht.listen_port", str(ports[peer]),
                    "--dht.initial_peers", f"127.0.0.1:{ports[other]}",
                    "--training.output_dir", pdir,
                    "--training.train_log_path", os.path.join(pdir, "train.jsonl"),
                    "--telemetry.event_log_path", os.path.join(pdir, "events.jsonl")],
                stdout=logs[peer], stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__)))
        deadline = time.time() + COLLAB_DEADLINE_S
        while time.time() < deadline:
            done = all(
                sum(r["group_size"] == 2 for r in
                    _jsonl(os.path.join(work, p, "train.jsonl"))) >= COLLAB_STEPS
                for p in procs)
            if done or any(pr.poll() is not None for pr in procs.values()):
                break
            time.sleep(1.0)
        for peer, pr in procs.items():
            if pr.poll() is not None:
                with open(os.path.join(work, peer, "log.txt")) as f:
                    fail(f"collab: peer {peer} exited early "
                         f"({pr.returncode}):\n{f.read()[-3000:]}")
    finally:
        for pr in procs.values():
            if pr.poll() is None:
                pr.send_signal(signal.SIGINT)
        for pr in procs.values():
            try:
                pr.wait(timeout=60)
            except subprocess.TimeoutExpired:
                pr.kill()
                pr.wait()
        for f in logs.values():
            f.close()
    wall_s = time.perf_counter() - t_start
    try:
        reports = {p: _peer_report(p, os.path.join(work, p), total)
                   for p in procs}
        common = sorted(set(reports["A"]["averaged_steps"])
                        & set(reports["B"]["averaged_steps"]))
        hashes = {}
        for step in common:
            paths = [os.path.join(work, p, f"checkpoint-{step}") for p in procs]
            if all(os.path.isdir(x) for x in paths):
                hashes[step] = [_state_hash(x) for x in paths]
        if not hashes:
            fail(f"collab: no averaged step checkpointed by both peers {common}")
        last = max(hashes)
        if hashes[last][0] != hashes[last][1]:
            fail(f"collab: the peers' states differ at their last common "
                 f"step {last}: {hashes[last]}")
        log(f"  state sha256 at common steps: "
            f"{ {s: h[0][:16] + ('=' if h[0] == h[1] else '!=') for s, h in hashes.items()} }")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(wall_s=wall_s, peers=reports, last_common_step=last,
                state_sha256=hashes[last][0],
                steps_equal={str(s): h[0] == h[1] for s, h in hashes.items()})


def phase_collab(seed: int) -> dict:
    t0 = time.perf_counter()
    checks = collab_card_checks(seed)
    gc.collect()
    torch.cuda.empty_cache()
    log("[collab] two trainer peers through the CLI on this card")
    path = collab_peers(seed, checks["flat_size"])
    for peer, rep in path["peers"].items():
        log(f"  peer {peer}: {json.dumps(rep)}")
    return dict(checks=checks, **path, phase_s=time.perf_counter() - t0)


def _kind(name: str) -> str:
    if "flash_" in name or "_ln_" in name:
        return "port kernels"
    if re.search(r"gemm|xmma|cutlass|nvjet|sm90_", name, re.IGNORECASE):
        return "matmul"
    return "other"


def profile_step(step, trace_name: str) -> dict:
    """Run ``step`` once under torch.profiler (device activity only) and
    return its host wall time, the device's busy time (the union of its
    kernel, memcpy and memset intervals), the idle share 1 - busy / wall,
    and device time by kind and by the costliest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from dedloc_tpu_torch.ops import _build

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace = _build.BUILD_DIR / trace_name
    prof.export_chrome_trace(str(trace))
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not events:
        fail("the profiler saw no device activity in the traced step")
    busy_us, end = 0.0, -math.inf
    for start, dur in sorted((e["ts"], e["dur"]) for e in events):
        busy_us += max(0.0, start + dur - max(start, end))
        end = max(end, start + dur)
    by_kind, by_name = {}, {}
    for e in events:
        kind = _kind(e["name"]) if e["cat"] == "kernel" else "copy/memset"
        by_kind[kind] = by_kind.get(kind, 0.0) + e["dur"] / 1e3
        ms_n = by_name.setdefault(e["name"][:100], [0.0, 0])
        ms_n[0] += e["dur"] / 1e3
        ms_n[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    prof_out = dict(
        wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
        idle_share=1.0 - busy_us / 1e3 / wall_ms, device_ops=len(events),
        by_kind_ms=by_kind, top=[[n, ms, c] for n, (ms, c) in top],
    )
    log(f"  traced step: {json.dumps(prof_out)}")
    return prof_out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import dedloc_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_device()
    build_s, build_regs = phase_build()
    kernels = phase_kernels(args.seed)
    phase_reference(args.seed)
    path = phase_path(args.seed)
    longctx = phase_longctx(args.seed)
    collab = phase_collab(args.seed)

    rows = []
    for k in kernels:
        name = k.pop("name")
        max_abs_err, samples_with_keys = k.pop("err")
        # launches: the count from the run of the path the row was measured at
        run = longctx if k["path"] == f"S={LONG_SEQ}" else path
        rows.append(dict(
            name=name, route=k.pop("route"), source=k.pop("source"),
            replaces=k.pop("replaces"), launches=run["launches"][name],
            launches_per_step=run["launches_per_step"][name],
            max_abs_err=max_abs_err, ms=k.pop("ms"), plain_ms=k.pop("plain_ms"),
            bound_ms=k.pop("bound_ms"), bound_by=k.pop("bound_by"),
            library_ms=k.pop("library_ms"), **k,
            samples_with_keys=samples_with_keys,
        ))
        if k["path"] == "S=512":
            # the same kernel in the two trainer peers of the collab phase
            rows[-1]["launches_collab"] = sum(
                rep["kernel_launches"][name] for rep in collab["peers"].values())
        if rows[-1]["route"] == "cuda":
            # ptxas at the path's head dim: the registers a thread is launched
            # with (the backward's consumer warpgroups raise theirs with
            # setmaxnreg), and the tensor-core rate this call reached
            rows[-1].update(build_regs[f"{name}_kernel<{k['shape'][3]}>"])
            rows[-1]["tflops"] = k["tensor_flops"] / (rows[-1]["ms"] * 1e-3) / 1e12
    print(json.dumps({"build": {"nvcc_seconds": build_s, "ptxas": build_regs}}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"path": path}))
    print(json.dumps({"longctx": longctx}))
    print(json.dumps({"collab": collab}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
