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
              used by the port; for add+LN the nearest calls: the fp32 add
              then native_layer_norm, and native_layer_norm_backward).
4. reference  the tiny config on the card (kernels) against the same
              weights and batch on the CPU (plain versions).
5. path       first the divisions the reference makes, card against CPU
              from identical inputs at ALBERT-large's parameter shapes:
              LAMB's bias-corrected moments at counts 1-3 and the
              accumulation of 3 micro-batches, bitwise (and the share of
              elements a Python-number divisor would change on the card).
              Then ALBERT-large (24 x 1024, 16 heads), micro-batch 12 x 512,
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
8. downstream the sahajBERT chain at ALBERT-large's width, with no
              tokenizers package: stdlib docstrings (``data/corpus.py``)
              under a word-level vocabulary (the most frequent words after
              the 5 special tokens, within 30,000 ids) become S=512 MLM+SOP
              shards (``data/prepare.py`` ``instance_batches``,
              ``data/disk.py``), every tenth document held out. One solo
              trainer peer through the CLI on the train shards (12 x 512,
              accumulation 2, remat fused_ln, flash, target batch 24, 4
              local steps, a checkpoint): 48/48/48/96/96 launches per
              boundary, finite losses starting near ln 30,000 + ln 2, no
              fallback. The evaluator CLI on that checkpoint over the
              held-out shards with flash + fused_ln and with dense + plain
              LN: MLM losses within DOWN_EVAL_MLM_TOL, the flash run again in
              this process identical, with 24 flash and 48 add+LN launches
              per batch; ms per batch of each. ``run_ner`` and ``run_ncc``
              warm-started from the checkpoint at the reference defaults
              (128 tokens, batch 32, lr 5e-5, classifier dropout 0.1), one
              epoch of 8 steps on corpus sentences labelled by fixed rules:
              finite losses, the metric keys, the best params restored and
              evaluating to their epoch's loss, no port kernel launched; ms
              per step and peak memory. Both heads on a tiny config, card
              against CPU.
9. swav       the SwAV peer, which launches none of the port's kernels
              (their counters must stay 0): the tiny config (bf16 trunk)
              card against CPU (embeddings, loss, gradients) and a
              [32 + 3840, 3000] fp32 sinkhorn card against CPU; the
              full-width fused local step (ResNet-50, head 2048 -> 2048 ->
              128, 3,000 prototypes, queue 3,840; 32 images = 64 x 224^2 +
              192 x 96^2 crops; LARS on a warmup-cosine schedule), 3 steps
              with the queue off and 2 with it on: finite losses, unit
              prototypes after each apply, one batch norm's running
              variance against the biased estimate of its input; one
              traced step; the flat LARS apply (with the prototype
              post_apply) against the per-leaf one over 3 steps; one step
              at bench.py's B=128 if it fits. Then a solo peer through
              ``python -m dedloc_tpu_torch.roles.swav`` at full width (4
              boundaries of 32 images, target batch 64, queue from global
              step 1): the queue engaged, every global step through the
              flat apply, a checkpoint, per-boundary phases from its
              telemetry events; and ``run_linear_probe`` on the eval-mode
              trunk's features from that checkpoint (a check, not a
              result).

10. moe      the Switch-MoE ALBERT peer (8 experts, capacity factor 1.25,
              aux weight 0.01). ``moe_ffn`` on the same bf16 tokens card
              against CPU (routing on the tokens with a top-1/top-2 gate
              margin above 1e-5, y on those kept, aux) and the tiny
              ALBERT-MoE (flash + fused_ln) card against CPU for 4 seeds
              (loss with aux, whole-gradient relative error). The
              full-width cell: ALBERT-large with 8 experts at 12 x 512,
              accumulation 2, remat fused_ln, flash, LAMB, 3 steps with the
              counters checked (48/48/48/96/96 per step) and one traced; the
              routing (share of tokens over capacity, aux per application)
              at init, held against the same model's on the CPU application
              by application, and after. The MoE layer at that shape: router, dispatch, expert
              products, combine, the layer and its dense einsum plain
              version (device time; forward + backward between events).
              Then the reference's deployment through the CLIs: a
              coordinator and an aux peer on the CPU (CUDA hidden), two
              tiny MoE trainers on the card; 2 averaged rounds, the
              trainers' states bitwise equal after every round, the aux in
              a round, two alive peers in the coordinator's JSONL. Last,
              the trainers' checkpoint served: expert hosts in NumPy and a
              gateway holding the router answer ``gateway.infer`` for 256
              tokens, within 2e-2 of max |ref| of ``moe_ffn`` on the card
              on the tokens it keeps; ms per request.

Prints a ``{"build": ...}`` line, a ``{"kernels": [...]}`` line, a
``{"path": ...}`` line, a ``{"longctx": ...}`` line, a ``{"collab": ...}``
line, a ``{"downstream": ...}`` line, a ``{"swav": ...}`` line, a
``{"moe": ...}`` line, the whole
script's seconds (``{"script_s": ...}``), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
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
                  plain_timing="CUDA graph")
    # the nearest PyTorch calls, timed only: the fp32 residual add then
    # native_layer_norm (forward: the cast, the add and the LN, 3 kernels);
    # native_layer_norm_backward from the fp32 sum and its saved statistics
    # (one call: dx, dgamma, dbeta)
    a = x.float().add_(r)
    _, mean_l, rstd_l = torch.native_layer_norm(a, [w], gamma, beta, eps)
    dy32 = dy.float()
    results.append(dict(
        name="ln_fwd", replaces="dedloc_tpu/ops/fused_ln.py:55",
        err=(fwd_err, None), tol="atol 1e-2 + rtol 1e-2 |ref|",
        ms=cuda_ms(lambda: fl.ln_fwd(x, r, gamma, beta, eps)),
        plain_ms=cuda_ms(lambda: fl.ln_fwd_plain(x, r, gamma, beta, eps)),
        library_ms=cuda_ms(lambda: torch.native_layer_norm(
            x.float().add_(r), [w], gamma, beta, eps)),
        library="x.float().add_(r) then torch.native_layer_norm "
                "(3 kernels: cast, add, LN; no x-hat output)",
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
        library_ms=cuda_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            dy32, a, [w], mean_l, rstd_l, gamma, beta, [True, True, True])),
        library="torch.ops.aten.native_layer_norm_backward (fp32 dy and "
                "input: one call)",
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
    auxes = []  # per micro-batch with experts: the MoE aux loss (all layers)

    def optimizer_step() -> None:
        nonlocal state
        grad_acc, n_acc = zeros_like_grads(params), 0
        for _ in range(args.gradient_accumulation_steps):
            batch = drop_collator_keys(next(batches), device="cuda")
            grad_acc, n_acc, metrics = accumulate(params, grad_acc, n_acc, batch)
            losses.append(metrics["loss"])
            parts.append((metrics["mlm_loss"], metrics["sop_loss"]))
            if "moe_aux" in metrics:
                auxes.append(metrics["moe_aux"])
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
    extra = {}
    if auxes:
        extra["moe_aux"] = [float(a) for a in auxes]
        log(f"  MoE aux (sum over {cfg.num_hidden_layers} layers) {extra['moe_aux']}")
        if not all(math.isfinite(a) for a in extra["moe_aux"]):
            fail(f"{tag}: non-finite MoE aux loss {extra['moe_aux']}")
    return dict(
        steps=steps, micro_batch=micro_batch, seq_length=seq,
        grad_accum=args.gradient_accumulation_steps, remat=cfg.remat,
        remat_policy=cfg.remat_policy, fused_ln=cfg.fused_ln, losses=losses,
        mlm_losses=mlm_losses, sop_losses=sop_losses,
        first_loss_at_init=at_init, step_ms=[t * 1e3 for t in step_s],
        ms_per_step=ms, samples_per_s=samples / (ms / 1e3),
        tokens_per_s=samples * seq / (ms / 1e3),
        max_memory_allocated=peak, launches=launches,
        launches_per_step=per_step[-1], profile=profile, **extra,
    )


def _large(cfg, seed: int):
    """ALBERT-large of ``cfg`` with random weights from ``seed`` on the card
    (what ``build_model`` does, for configs it does not name)."""
    from dedloc_tpu_torch.models.albert import AlbertForPreTraining, init_weights

    model = AlbertForPreTraining(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to("cuda")


def divisor_checks(seed: int) -> dict:
    """The divisions the reference makes, on the card against the CPU from
    identical inputs at ALBERT-large's parameter shapes: LAMB's
    bias-corrected moments at int counts 1, 2, 3 and the local step's
    accumulation of 3 micro-batches must be bitwise equal (both divide by a
    0-d tensor on the device). Also counts the elements a Python-number
    divisor, which CUDA applies as a reciprocal multiply, would change."""
    from dedloc_tpu_torch.optim.lamb import Lamb, bias_corrections, debiased
    from dedloc_tpu_torch.parallel.train_step import add_micro_grads, zeros_like_grads
    from dedloc_tpu_torch.roles.common import build_model

    log("[path] divisions on the card against the CPU (ALBERT-large shapes)")
    _cfg, model = build_model("large", device="cpu", seed=seed)
    params = {k: v.detach() for k, v in model.named_parameters()}
    gen = torch.Generator().manual_seed(seed)
    grads = [{k: torch.randn(p.shape, generator=gen) * 1e-3
              for k, p in params.items()} for _ in range(3)]
    runs = {}
    for device in ("cuda", "cpu"):
        tx = Lamb(learning_rate=1e-3, weight_decay=0.01)
        p = {k: v.to(device) for k, v in params.items()}
        state, hats, host_divisor = tx.init(p), [], []
        for g in grads:
            _upd, state = tx.update({k: v.to(device) for k, v in g.items()},
                                    state, p)
            bc1, bc2 = bias_corrections(tx.b1, tx.b2, state.count)
            hats.append({k: [t.cpu() for t in debiased(state.mu[k], state.nu[k],
                                                       bc1, bc2)]
                         for k in p})
            host_divisor.append({k: [(state.mu[k] / bc1).cpu(),
                                     (state.nu[k] / bc2).cpu()] for k in p})
        acc = zeros_like_grads(p)
        python_acc = zeros_like_grads(p)
        for g in grads:
            g = {k: v.to(device) for k, v in g.items()}
            add_micro_grads(acc, g, 3)
            for k, v in g.items():
                python_acc[k].add_(v / 3)
        runs[device] = (hats, host_divisor, {k: v.cpu() for k, v in acc.items()},
                        {k: v.cpu() for k, v in python_acc.items()})
    (hats_c, host_c, acc_c, pacc_c), (hats_p, _h, acc_p, _pa) = runs["cuda"], runs["cpu"]
    n = sum(t.numel() for t in params.values())
    out = {"elements": n, "counts": [1, 2, 3]}
    for count, (hc, hp, pc) in enumerate(zip(hats_c, hats_p, host_c), start=1):
        for i, what in enumerate(("mu_hat", "nu_hat")):
            same = all(torch.equal(hc[k][i], hp[k][i]) for k in hp)
            if not same:
                fail(f"path: LAMB {what} at count {count} card != cpu")
            differ = sum(int((pc[k][i] != hp[k][i]).sum()) for k in hp)
            out[f"{what}_{count}"] = dict(bitwise=True,
                                          python_divisor_share=differ / n)
    if not all(torch.equal(acc_c[k], acc_p[k]) for k in acc_p):
        fail("path: the accumulated gradient at grad_accum_steps=3 card != cpu")
    differ = sum(int((pacc_c[k] != acc_p[k]).sum()) for k in acc_p)
    out["accum_3"] = dict(bitwise=True, python_divisor_share=differ / n)
    log(f"  bitwise card == cpu: LAMB m_hat, v_hat at counts 1-3 and the "
        f"accumulation of 3; a Python-number divisor would change "
        f"{ {k: round(v['python_divisor_share'], 4) for k, v in out.items() if isinstance(v, dict)} } "
        f"of {n} elements")
    return out


def phase_path(seed: int, micro_batch: int = 12, seq: int = 512) -> dict:
    from dedloc_tpu_torch.roles.common import build_model

    divisors = divisor_checks(seed)

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
    return dict(remat, divisors=divisors, no_remat={k: keep_all[k] for k in (
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


# ----------------------------------------------------------------- phase 8

DOWN_SEQ = 512
DOWN_BATCH = 12
DOWN_BOUNDARIES = 4  # the trainer's local steps (2 x 12 x 512 each)
DOWN_EVAL_BATCHES = 8
# |flash + fused_ln - dense + plain LN| allowed on the evaluator's mean MLM
# loss over 8 held-out batches (96 x 512, ~7,000 masked positions). The two
# paths round differently: flash rounds exp(s - m) to bf16 against running
# maxima before normalising, dense rounds the normalised probabilities; the
# fused add+LN rounds y once from its own fp32 statistics. Each is a 2^-9
# relative flip of a bf16 element, through 24 layers. WITNESS_MLM_TOL (1e-4)
# held flash against blockwise with the same LN; phase_reference's 2e-2 holds
# a whole tiny model card vs CPU. This sits between them: a wrong tile, mask,
# scale or LN moves the loss by far more.
DOWN_EVAL_MLM_TOL = 1e-3
FT_SEQ, FT_BATCH = 128, 32  # the reference fine-tunes' defaults
FT_TRAIN, FT_EVAL = 8 * FT_BATCH, 2 * FT_BATCH  # one epoch of 8 steps
_WORDS = re.compile(r"\w+|[^\w\s]")


class WordVocab:
    """Word-level ids for the smoke corpus: the 5 special tokens of
    ``data/mlm.py`` ``SpecialTokens`` (pad, unk, [CLS], [SEP], [MASK]), then
    the most frequent lower-cased words, within ``size`` ids; other words
    are unk (1). The phase needs no ``tokenizers`` package."""

    def __init__(self, docs, size: int):
        import collections

        counts = collections.Counter(
            w for d in docs for w in _WORDS.findall(d.lower()))
        self.words = [w for w, _ in counts.most_common(size - 5)]
        self.ids = {w: 5 + i for i, w in enumerate(self.words)}

    def encode(self, text: str) -> list:
        return [self.ids.get(w, 1) for w in _WORDS.findall(text.lower())]


def downstream_shards(seed: int, work: str) -> tuple:
    """Stdlib docstrings (``data/corpus.py``) -> word ids -> MLM+SOP
    instances at S=512 (``data/prepare.py``) -> shards (``data/disk.py``):
    every tenth document held out. Returns (counts and paths, the
    vocabulary, the documents)."""
    import sysconfig

    from dedloc_tpu_torch.data.corpus import harvest
    from dedloc_tpu_torch.data.disk import write_shards
    from dedloc_tpu_torch.data.mlm import SpecialTokens
    from dedloc_tpu_torch.data.prepare import instance_batches
    from dedloc_tpu_torch.data.streaming import split_sentences

    t0 = time.perf_counter()
    docs = list(harvest([sysconfig.get_paths()["stdlib"]]))
    harvest_s = time.perf_counter() - t0
    tokens = SpecialTokens()  # ALBERT-large's vocab of 30,000
    vocab = WordVocab(docs, tokens.vocab_size)
    splits = {"train": [d for i, d in enumerate(docs) if i % 10],
              "holdout": docs[::10]}
    out = dict(documents=len(docs), harvest_s=harvest_s,
               vocab_ids=5 + len(vocab.words))
    for name, split in splits.items():
        path = os.path.join(work, name)
        n_tokens = [0]

        def counted(batches):
            for b in batches:
                n_tokens[0] += int((b["input_ids"] != tokens.pad_id).sum())
                yield b

        total = write_shards(path, counted(instance_batches(
            iter(split),
            lambda doc: [vocab.encode(x) for x in split_sentences(doc)],
            tokens, DOWN_SEQ, 256, seed)), examples_per_shard=1024)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"vocab_size": tokens.vocab_size,
                       "max_seq_length": DOWN_SEQ, "num_instances": total}, f)
        out[name] = dict(path=path, documents=len(split), instances=total,
                         tokens=n_tokens[0])
    log(f"[downstream] corpus: {out['documents']} stdlib documents in "
        f"{harvest_s:.1f} s, {out['vocab_ids']} word ids; train "
        f"{out['train']['documents']} docs / {out['train']['instances']} "
        f"instances / {out['train']['tokens']} tokens, holdout "
        f"{out['holdout']['documents']} / {out['holdout']['instances']} / "
        f"{out['holdout']['tokens']}")
    return out, vocab, docs


def downstream_trainer(seed: int, work: str, shards: str) -> dict:
    """One solo trainer peer through the CLI on the train shards: target 24
    (its own 2 x 12), 4 local steps, a checkpoint at the end."""
    out_dir = os.path.join(work, "trainer")
    log_path = os.path.join(work, "trainer.jsonl")
    events_path = os.path.join(work, "events.jsonl")
    cmd = [sys.executable, "-m", "dedloc_tpu_torch.roles.trainer",
           "--dht.experiment_prefix", "chip-smoke-downstream",
           "--dht.listen_host", "127.0.0.1",
           "--dht.listen_port", str(_free_port()), *COLLAB_MODEL_FLAGS,
           "--training.dataset_path", shards,
           "--training.gradient_accumulation_steps", "2",
           "--training.warmup_steps", "0", "--training.seed", str(seed),
           "--training.max_local_steps", str(DOWN_BOUNDARIES),
           "--training.save_steps", "1", "--training.save_total_limit", "1",
           "--training.output_dir", out_dir,
           "--training.train_log_path", log_path,
           "--optimizer.target_batch_size", str(2 * DOWN_BATCH),
           "--checkpoint.cache_dir", "none",
           "--telemetry.enabled", "true",
           "--telemetry.event_log_path", events_path,
           # a solo peer finds no partner: do not wait 5 s for one
           "--averager.averaging_expiration", "0.5",
           "--averager.min_refresh_period", "0.2",
           "--averager.default_refresh_period", "0.5"]
    log(f"[downstream] trainer: {' '.join(cmd[3:])}")
    t0 = time.perf_counter()
    with open(os.path.join(work, "trainer.log"), "w") as logf:
        proc = subprocess.run(cmd, stdout=logf, stderr=subprocess.STDOUT,
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              timeout=420)
    wall_s = time.perf_counter() - t0
    with open(os.path.join(work, "trainer.log")) as f:
        text = f.read()
    if proc.returncode:
        fail(f"downstream: the trainer exited {proc.returncode}:\n{text[-3000:]}")
    for marker in FALLBACKS:
        if marker in text:
            fail(f"downstream: the trainer fell back: {marker!r}")
    records = _jsonl(log_path)
    if len(records) < 2:  # 2 global steps of 2 boundaries each
        fail(f"downstream: the trainer logged {len(records)} global steps "
             f"(want 2); log tail:\n{text[-3000:]}")
    prev = {"boundaries": 0, "kernel_launches": {k: 0 for k in COLLAB_EXPECTED}}
    for r in records:
        nb = r["boundaries"] - prev["boundaries"]
        got = {k: r["kernel_launches"][k] - prev["kernel_launches"][k]
               for k in COLLAB_EXPECTED}
        if got != {k: v * nb for k, v in COLLAB_EXPECTED.items()}:
            fail(f"downstream: the trainer launched {got} in {nb} boundaries "
                 f"(want {COLLAB_EXPECTED} each)")
        prev = r
    losses = [r["loss"] for r in records]
    at_init = math.log(30000) + math.log(2)
    if not all(math.isfinite(x) for x in losses):
        fail(f"downstream: non-finite trainer loss {losses}")
    if abs(losses[0] - at_init) > 0.5:
        fail(f"downstream: first loss {losses[0]:.4f} not within 0.5 of "
             f"{at_init:.4f}")
    ckpts = sorted(d for d in os.listdir(out_dir) if d.startswith("checkpoint-"))
    if not ckpts:
        fail("downstream: the trainer saved no checkpoint")
    # each boundary's time from its StepRecorder event; the first pays the
    # warm-up (and the kernels' build when nothing was built before)
    steps = [e for e in _jsonl(events_path) if e.get("event") == "step.record"]
    if len(steps) != DOWN_BOUNDARIES:
        fail(f"downstream: {len(steps)} step records for {DOWN_BOUNDARIES} "
             f"boundaries")
    rest = steps[1:]
    med = lambda xs: statistics.median(xs) if xs else None
    busy_s = sum(e["dur_s"] for e in rest)
    out = dict(
        wall_s=wall_s, global_steps=[r["step"] for r in records],
        group_sizes=[r["group_size"] for r in records], losses=losses,
        first_loss_at_init=at_init,
        boundary_ms=[e["dur_s"] * 1e3 for e in steps],
        stepped=[bool(e.get("stepped")) for e in steps],
        stepped_boundary_ms=med([e["dur_s"] * 1e3 for e in rest if e.get("stepped")]),
        other_boundary_ms=med([e["dur_s"] * 1e3 for e in rest if not e.get("stepped")]),
        phases_ms={k: med([e["phases"].get(k, 0.0) * 1e3 for e in rest])
                   for k in sorted({k for e in rest for k in e.get("phases", {})})},
        samples_per_s=2 * DOWN_BATCH * len(rest) / busy_s,
        tokens_per_s=2 * DOWN_BATCH * DOWN_SEQ * len(rest) / busy_s,
        kernel_launches=records[-1]["kernel_launches"],
        boundaries=records[-1]["boundaries"],
        max_memory_allocated=records[-1].get("max_memory_allocated"),
        checkpoint=os.path.join(out_dir, ckpts[-1]), output_dir=out_dir)
    log(f"  trainer: {json.dumps(out)}")
    return out


def _eval_flags(seed: int, holdout: str, ckpt_dir: str, impl: str) -> list:
    base = ["--training.model_size", "large",
            "--training.per_device_batch_size", str(DOWN_BATCH),
            "--training.seq_length", str(DOWN_SEQ),
            "--training.dataset_path", holdout,
            "--training.output_dir", ckpt_dir, "--training.seed", str(seed),
            "--eval.max_batches", str(DOWN_EVAL_BATCHES)]
    if impl == "flash":
        return base + ["--training.attention_impl", "flash",
                       "--training.remat_policy", "fused_ln"]
    return base + ["--training.attention_impl", "dense"]


def _eval_batch_ms(seed: int, holdout: str, ckpt_dir: str, impl: str) -> float:
    """One held-out batch's forward and loss, as ``run_eval`` runs it, between
    CUDA events (median of 5, launches included)."""
    from dedloc_tpu_torch.core.config import parse_config
    from dedloc_tpu_torch.data.disk import tokenized_dataset_batches
    from dedloc_tpu_torch.roles import evaluate
    from dedloc_tpu_torch.roles.common import (
        build_loss_fn, build_model, drop_collator_keys,
    )
    from dedloc_tpu_torch.utils.checkpoint import load_latest_checkpoint

    tr = parse_config(evaluate.EvalCLIArguments,
                      _eval_flags(seed, holdout, ckpt_dir, impl)).training
    cfg, model = build_model(tr.model_size, tr.remat_policy, tr.attention_impl,
                             device="cuda")
    evaluate._restore(model, load_latest_checkpoint(ckpt_dir)[1])
    loss_fn = build_loss_fn(model)
    params = dict(model.named_parameters())
    batch = drop_collator_keys(next(tokenized_dataset_batches(
        holdout, cfg, DOWN_BATCH, DOWN_SEQ, seed)), device="cuda")
    with torch.no_grad():
        return event_ms(lambda: loss_fn(params, batch), reps=5)


def downstream_eval(seed: int, holdout: str, ckpt_dir: str) -> dict:
    """The evaluator CLI on the trainer's checkpoint over the held-out
    shards: flash + fused_ln (kernels #1, #5) and dense + plain LN; then the
    flash run again in this process, its launches counted."""
    import contextlib

    from dedloc_tpu_torch.core.config import parse_config
    from dedloc_tpu_torch.ops import flash_attention as fa
    from dedloc_tpu_torch.ops import fused_ln as fl
    from dedloc_tpu_torch.roles.evaluate import EvalCLIArguments, run_eval

    cli = {}
    for impl in ("flash", "dense"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "dedloc_tpu_torch.roles.evaluate",
             *_eval_flags(seed, holdout, ckpt_dir, impl)],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode:
            fail(f"downstream: the {impl} evaluator exited {proc.returncode}:"
                 f"\n{proc.stderr[-3000:]}")
        cli[impl] = json.loads(proc.stdout.strip().splitlines()[-1])
        cli[impl]["wall_s"] = time.perf_counter() - t0
        log(f"  evaluate ({impl}): {json.dumps(cli[impl])}")
    args = parse_config(EvalCLIArguments,
                        _eval_flags(seed, holdout, ckpt_dir, "flash"))
    wrappers = fa.WRAPPERS + fl.WRAPPERS
    for w in wrappers:
        w.launches = 0
    with contextlib.redirect_stdout(sys.stderr):  # its JSON line
        again = run_eval(args, args.eval)
    launches = {w.__name__: w.launches for w in wrappers}
    n = DOWN_EVAL_BATCHES
    expected = {"flash_fwd": 24 * n, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0,
                "ln_fwd": 48 * n, "ln_bwd": 0}
    if launches != expected:
        fail(f"downstream: the flash evaluator launched {launches} != {expected}")
    flash = {k: v for k, v in cli["flash"].items() if k != "wall_s"}
    if again != flash:
        fail(f"downstream: a second flash evaluation differs: {again} vs {flash}")
    for key in ("mlm_loss", "sop_loss"):
        if not all(math.isfinite(cli[i][key]) for i in cli):
            fail(f"downstream: non-finite eval {key}")
    gap = abs(cli["flash"]["mlm_loss"] - cli["dense"]["mlm_loss"])
    log(f"  flash vs dense mlm_loss {gap:.3e} (tol {DOWN_EVAL_MLM_TOL:.0e}); "
        f"a second flash run identical; launches {launches}")
    if not gap <= DOWN_EVAL_MLM_TOL:
        fail(f"downstream: flash mlm_loss {cli['flash']['mlm_loss']} vs dense "
             f"{cli['dense']['mlm_loss']}: {gap:.3e} > {DOWN_EVAL_MLM_TOL:.0e}")
    ms = {impl: _eval_batch_ms(seed, holdout, ckpt_dir, impl)
          for impl in ("flash", "dense")}
    log(f"  ms per eval batch (12 x 512): {ms}")
    return dict(flash=cli["flash"], dense=cli["dense"], mlm_gap=gap,
                mlm_tol=DOWN_EVAL_MLM_TOL,
                sop_gap=abs(cli["flash"]["sop_loss"] - cli["dense"]["sop_loss"]),
                repeat_identical=True, launches=launches,
                ms_per_batch=ms)


def _ner_examples(sentences: list) -> list:
    """Word lists with BIO tags from a fixed rule: a capitalised word after
    the first opens an entity (PER, ORG or LOC by its length mod 3) and the
    capitalised words right after it continue it."""
    kinds = ("PER", "ORG", "LOC")
    labels = {t: i for i, t in enumerate(
        ["O", "B-PER", "I-PER", "B-ORG", "I-ORG", "B-LOC", "I-LOC"])}
    examples = []
    for sent in sentences:
        words = _WORDS.findall(sent)
        tags, open_kind = [], None
        for i, w in enumerate(words):
            if i and w[:1].isupper():
                if open_kind is None:
                    open_kind = kinds[len(w) % 3]
                    tags.append(labels["B-" + open_kind])
                else:
                    tags.append(labels["I-" + open_kind])
            else:
                open_kind = None
                tags.append(labels["O"])
        examples.append({"tokens": words, "ner_tags": tags})
    return examples


def downstream_finetune(seed: int, vocab: WordVocab, docs: list,
                        trainer_dir: str) -> dict:
    """``run_ner`` and ``run_ncc`` at the reference defaults (128 tokens,
    batch 32, lr 5e-5, classifier dropout 0.1) for one epoch of 8 steps,
    the backbone warm-started from the trainer's checkpoint; examples from
    corpus sentences with labels from fixed rules."""
    from dedloc_tpu_torch.data.streaming import split_sentences
    from dedloc_tpu_torch.finetune import driver, ncc, ner
    from dedloc_tpu_torch.finetune.driver import FinetuneArguments
    from dedloc_tpu_torch.ops import flash_attention as fa
    from dedloc_tpu_torch.ops import fused_ln as fl

    sentences = [s for d in docs for s in split_sentences(d)
                 if 4 <= len(_WORDS.findall(s)) <= 60]
    need = FT_TRAIN + FT_EVAL
    if len(sentences) < need:
        fail(f"downstream: {len(sentences)} corpus sentences < {need}")
    sentences = sentences[:need]
    backbone = ner.load_backbone_params(trainer_dir)
    cfg = ner.resolve_model_config("large", 30000, FT_SEQ)
    train = FinetuneArguments(num_train_epochs=1, per_device_batch_size=FT_BATCH,
                              learning_rate=5e-5, classifier_dropout=0.1,
                              seed=seed)

    def tokenize_words(words):
        ids = [vocab.ids.get(w.lower(), 1) for w in words]
        return {"input_ids": [2] + ids + [3],
                "word_ids": [None] + list(range(len(ids))) + [None]}

    def tokenize_text(text):
        return [2] + vocab.encode(text) + [3]

    ncc_examples = [{"text": s, "label": len(_WORDS.findall(s)) % 6}
                    for s in sentences]
    ner_examples = _ner_examples(sentences)
    tasks = {
        "ner": (ner, lambda: ner.run_ner(
            ner.NerArguments(max_seq_length=FT_SEQ, train=train), cfg,
            ner_examples[:FT_TRAIN], ner_examples[FT_TRAIN:], tokenize_words,
            init_params=backbone, sep_token_id=3, device="cuda"),
            lambda: ner.encode_ner_examples(ner_examples[FT_TRAIN:],
                                            tokenize_words, FT_SEQ,
                                            sep_token_id=3),
            "eval_f1"),
        "ncc": (ncc, lambda: ncc.run_ncc(
            ncc.NccArguments(max_seq_length=FT_SEQ, train=train), cfg,
            ncc_examples[:FT_TRAIN], ncc_examples[FT_TRAIN:], tokenize_text,
            init_params=backbone, sep_token_id=3, device="cuda"),
            lambda: ncc.encode_ncc_examples(ncc_examples[FT_TRAIN:],
                                            tokenize_text, FT_SEQ,
                                            sep_token_id=3),
            "eval_accuracy"),
    }
    wrappers = fa.WRAPPERS + fl.WRAPPERS
    real_batches, real_finetune = driver._batches, driver.finetune
    out = {"train_examples": FT_TRAIN, "eval_examples": FT_EVAL,
           "sentences": len(sentences)}
    for task, (module, run, eval_data, metric) in tasks.items():
        step_s, seen = [], {}

        def timed_batches(*a, **kw):
            # a step ends in the driver's float(loss): the time between two
            # batches handed out is one train step
            t = time.perf_counter()
            for b in real_batches(*a, **kw):
                yield b
                now = time.perf_counter()
                step_s.append(now - t)
                t = now

        def recording(model, *a, **kw):
            seen["model"] = model
            return real_finetune(model, *a, **kw)

        driver._batches, module.finetune = timed_batches, recording
        for w in wrappers:
            w.launches = 0
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            best, history = run()
        finally:
            driver._batches, module.finetune = real_batches, real_finetune
        wall_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {w.__name__: w.launches for w in wrappers}
        if any(launches.values()):
            fail(f"downstream: {task} fine-tuning launched {launches}")
        if len(history) != 1 or len(step_s) != 8:
            fail(f"downstream: {task} ran {len(history)} epochs, "
                 f"{len(step_s)} steps (want 1, 8)")
        record = history[0]
        if not (math.isfinite(record["train_loss"])
                and math.isfinite(record["eval_loss"]) and metric in record):
            fail(f"downstream: {task} record {record}")
        model = seen["model"]
        if next(model.parameters()).device.type != "cuda":
            fail(f"downstream: {task} did not run on the card")
        for name, p in model.named_parameters():
            if not torch.equal(p.detach(), best[name]):
                fail(f"downstream: {task} model does not hold the best params")
        again, _ = driver.evaluate(model, eval_data(), FT_BATCH)
        if not abs(again - record["eval_loss"]) <= 1e-5 * abs(record["eval_loss"]):
            fail(f"downstream: {task} restored params evaluate to {again}, "
                 f"the best epoch's to {record['eval_loss']}")
        ms = statistics.median(step_s[1:]) * 1e3
        out[task] = dict(history=history, wall_s=wall_s,
                         step_ms=[t * 1e3 for t in step_s], ms_per_step=ms,
                         samples_per_s=FT_BATCH / (ms / 1e3),
                         max_memory_allocated=peak, restored_eval_loss=again,
                         launches=launches)
        log(f"  {task}: {json.dumps(out[task])}")
        del model, best, seen
    return out


def downstream_heads(seed: int) -> dict:
    """Both heads on a tiny config, the same weights on the card and the
    CPU, dropout 0: logits and classification_loss at phase_reference's
    tolerances (bf16 logits as tests/test_torch_albert.py's)."""
    from dedloc_tpu_torch.models.albert import (
        AlbertConfig, AlbertForSequenceClassification,
        AlbertForTokenClassification, classification_loss, init_weights,
    )

    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(5, 512, (4, 64), generator=gen)
    mask = torch.ones_like(ids)
    mask[1, 40:] = 0
    out = {}
    for cls, shape in ((AlbertForTokenClassification, (4, 64)),
                       (AlbertForSequenceClassification, (4,))):
        labels = torch.randint(0, 7, shape, generator=gen)
        res = {}
        for device in ("cuda", "cpu"):
            model = cls(AlbertConfig.tiny(), num_labels=7, classifier_dropout=0.0)
            init_weights(model, torch.Generator().manual_seed(seed))
            model.to(device)
            with torch.no_grad():
                logits = model(ids.to(device), mask.to(device))
                loss, _ = classification_loss(logits, labels.to(device))
            res[device] = (logits.cpu(), float(loss))
        err = check_close(f"{cls.__name__} logits card vs cpu", res["cuda"][0],
                          res["cpu"][0], 5e-2, 5e-2)
        gap = abs(res["cuda"][1] - res["cpu"][1])
        if not gap <= 2e-2:
            fail(f"downstream: {cls.__name__} loss card {res['cuda'][1]} vs "
                 f"cpu {res['cpu'][1]} (tol 2e-2)")
        out[cls.__name__] = dict(logits_max_abs_err=err, loss_gap=gap)
    return out


def phase_downstream(seed: int) -> dict:
    """The sahajBERT chain on the card: real text -> shards -> a trainer
    peer -> the held-out evaluator -> NER and NCC fine-tuning."""
    from dedloc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="downstream-", dir=_build.BUILD_DIR)
    try:
        data, vocab, docs = downstream_shards(seed, work)
        trainer = downstream_trainer(seed, work, data["train"]["path"])
        evals = downstream_eval(seed, data["holdout"]["path"],
                                trainer["output_dir"])
        gc.collect()
        torch.cuda.empty_cache()
        finetune = downstream_finetune(seed, vocab, docs, trainer["output_dir"])
        heads = downstream_heads(seed)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(data=data, trainer=trainer, eval=evals, finetune=finetune,
                heads=heads, phase_s=time.perf_counter() - t0)


# ----------------------------------------------------------------- phase 9

SWAV_BATCH = 32  # images per micro-batch: 64 x 224^2 + 192 x 96^2 crops
SWAV_QUEUE = 3840  # bench.py's queue_length
SWAV_BENCH_BATCH = 128  # bench.py's B
SWAV_LOCAL_STEPS = (3, 2)  # fused local steps with the queue off, then on
SWAV_CLI_BOUNDARIES = 4
# card vs CPU, tiny bf16 config (tests/test_torch_swav.py's bf16 bounds):
# features 2e-2 relative of max |ref|, loss 1e-2 relative, the whole
# gradient within 0.2 relative error and cosine >= 0.98
SWAV_FEAT_RTOL, SWAV_LOSS_RTOL = 2e-2, 1e-2
SWAV_GRAD_REL, SWAV_GRAD_COS = 0.2, 0.98
SWAV_SINKHORN_ATOL = 1e-5
SWAV_FLAT_RTOL = 1e-6  # flat LARS vs per-leaf, of each leaf's max |ref|


def _port_launches() -> dict:
    from dedloc_tpu_torch.ops import flash_attention as fa
    from dedloc_tpu_torch.ops import fused_ln as fl

    return {w.__name__: w.launches for w in fa.WRAPPERS + fl.WRAPPERS}


def swav_tiny_card_vs_cpu(seed: int) -> dict:
    """The tiny SwAV (bf16 trunk) from the same weights and crops on the
    card and on the CPU: embeddings, loss and gradients; then a full-width
    sinkhorn on [32 + 3840, 3000] fp32 scores."""
    import copy

    from dedloc_tpu_torch.data.multicrop import MultiCropSpec, synthetic_multicrop_batches
    from dedloc_tpu_torch.models.resnet import init_batch_stats, init_weights
    from dedloc_tpu_torch.models.swav import (
        SwAVConfig, SwAVModel, crop_tensors, sinkhorn_knopp, swav_loss,
    )

    log("[swav] tiny SwAV (bf16 trunk): card vs CPU")
    cfg = SwAVConfig.tiny()
    cpu_model = init_weights(SwAVModel(cfg), torch.Generator().manual_seed(seed))
    crops = next(synthetic_multicrop_batches(MultiCropSpec.tiny(), 8, seed=seed))
    out = {}
    for device, model in (("cuda", copy.deepcopy(cpu_model).cuda()), ("cpu", cpu_model)):
        params = dict(model.named_parameters())
        emb, scores, _ = model(crop_tensors(crops, device), init_batch_stats(model), True)
        loss = swav_loss(scores, cfg)
        grads = torch.autograd.grad(loss, list(params.values()))
        out[device] = (emb.detach().float().cpu(), float(loss.detach()),
                       torch.cat([g.float().cpu().reshape(-1) for g in grads]))
    (emb_c, loss_c, g_c), (emb_p, loss_p, g_p) = out["cuda"], out["cpu"]
    feat_err = check_close("swav tiny embeddings", emb_c, emb_p,
                           SWAV_FEAT_RTOL * float(emb_p.abs().max()), SWAV_FEAT_RTOL)
    if not math.isfinite(loss_c) or abs(loss_c - loss_p) > SWAV_LOSS_RTOL * abs(loss_p):
        fail(f"swav tiny loss card {loss_c} vs cpu {loss_p}")
    grad_rel = float((g_c - g_p).norm() / g_p.norm())
    grad_cos = float(g_c @ g_p / (g_c.norm() * g_p.norm()))
    if not (grad_rel < SWAV_GRAD_REL and grad_cos > SWAV_GRAD_COS):
        fail(f"swav tiny gradients: relative error {grad_rel:.3e}, cosine {grad_cos:.5f}")
    log(f"  loss card {loss_c:.6f} cpu {loss_p:.6f}; gradient relative error "
        f"{grad_rel:.3e}, cosine {grad_cos:.5f}")
    # full-width sinkhorn: unit embeddings against unit prototypes
    gen = torch.Generator().manual_seed(seed)
    emb = torch.nn.functional.normalize(torch.randn(32 + SWAV_QUEUE, 128, generator=gen), dim=1)
    protos = torch.nn.functional.normalize(torch.randn(3000, 128, generator=gen), dim=1)
    scores = emb @ protos.t()
    scores_d = scores.cuda()
    sk_c = sinkhorn_knopp(scores_d)
    sk_p = sinkhorn_knopp(scores)
    sk_err = check_close("sinkhorn [3872, 3000]", sk_c.cpu(), sk_p, SWAV_SINKHORN_ATOL, 0.0)
    sk_ms = cuda_ms(lambda: sinkhorn_knopp(scores_d), reps=10, calls=3)
    return dict(loss_card=loss_c, loss_cpu=loss_p, embeddings_max_abs_err=feat_err,
                grad_rel_err=grad_rel, grad_cos=grad_cos, sinkhorn_max_abs_err=sk_err,
                sinkhorn_ms=sk_ms)


def _swav_state(cfg, seed: int, tx):
    from dedloc_tpu_torch.models.resnet import init_batch_stats
    from dedloc_tpu_torch.models.swav import SwAVQueue, SwAVTrainState, init_swav

    model, params, stats = init_swav(cfg, seed, "cuda")
    queue = SwAVQueue.create(cfg, torch.Generator().manual_seed(seed + 1), "cuda")
    return model, SwAVTrainState(step=0, params=params, batch_stats=stats,
                                 opt_state=tx.init(params), queue=queue)


def _swav_crops(batch: int, seed: int) -> list:
    from dedloc_tpu_torch.data.multicrop import MultiCropSpec, synthetic_multicrop_batches
    from dedloc_tpu_torch.models.swav import crop_tensors

    return crop_tensors(next(synthetic_multicrop_batches(MultiCropSpec(), batch, seed=seed)),
                        "cuda")


def swav_local(seed: int) -> dict:
    """Full width (ResNet-50, head 2048 -> 2048 -> 128, 3,000 prototypes,
    queue 3,840), 32 images a step, LARS on a warmup-cosine schedule: the
    fused local step, its checks, a traced step, and one step at B=128."""
    from dedloc_tpu_torch.averaging.device_flat import DeviceFlatPipeline
    from dedloc_tpu_torch.models.swav import (
        SwAVConfig, make_prototype_post_apply, make_swav_accumulate_step,
        make_swav_train_step,
    )
    from dedloc_tpu_torch.optim.flat import FlatLars
    from dedloc_tpu_torch.optim.lars import Lars
    from dedloc_tpu_torch.optim.schedules import linear_warmup_cosine_annealing
    from dedloc_tpu_torch.parallel.train_step import (
        TrainState, make_flat_apply_step, make_guarded_apply_step, zeros_like_grads,
    )

    cfg = SwAVConfig(queue_length=SWAV_QUEUE)
    schedule = linear_warmup_cosine_annealing(0.6, 2, 100)
    tx = Lars(schedule, momentum=0.9, weight_decay=1e-6)
    model, state = _swav_state(cfg, seed, tx)
    n_params = sum(p.numel() for p in state.params.values())
    crops = _swav_crops(SWAV_BATCH, seed)
    log(f"[swav] ResNet-50 SwAV, {n_params:,} params, crops "
        f"{[tuple(c.shape) for c in crops]}, queue {SWAV_QUEUE}")
    step = make_swav_train_step(model, cfg, tx)
    # one BN layer's input, for its running variance
    bn = model.head.proj_bn0
    seen = {}

    def keep_input(_module, args):
        seen.setdefault("x", args[0].detach().double())

    hook = bn.register_forward_pre_hook(keep_input)
    var_before = state.batch_stats["head.proj_bn0.var"].double().clone()
    losses, step_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i, use_queue in enumerate([False] * SWAV_LOCAL_STEPS[0] + [True] * SWAV_LOCAL_STEPS[1]):
        t0 = time.perf_counter()
        state, metrics = step(state, crops, use_queue)
        loss = float(metrics["loss"])  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if not math.isfinite(loss):
            fail(f"swav local step {i}: loss {loss}")
        norms = state.params["head.prototypes0.weight"].detach().double().norm(dim=1)
        if float((norms - 1).abs().max()) > 1e-6:
            fail(f"swav local step {i}: prototype norms off by "
                 f"{float((norms - 1).abs().max()):.3e}")
        if i == 0:
            hook.remove()
            x = seen["x"]
            want = 0.9 * var_before + 0.1 * x.var(dim=0, unbiased=False)
            got = state.batch_stats["head.proj_bn0.var"].double()
            var_err = float(((got - want).abs() / want.abs()).max())
            unbiased_gap = x.shape[0] / (x.shape[0] - 1) - 1
            if var_err > 1e-5:
                fail(f"swav BN running var {var_err:.3e} from the biased estimate")
            log(f"  BN running var vs biased estimate: {var_err:.3e} relative "
                f"(the unbiased one would be {unbiased_gap:.2e} off over {x.shape[0]} rows)")
    peak = torch.cuda.max_memory_allocated()
    log(f"  local steps: losses {losses}, ms {[round(t, 2) for t in step_ms]}, "
        f"peak {peak:,} bytes")
    timed = step_ms[1:]  # the first pays cuDNN's set-up
    med_ms = statistics.median(timed)
    trace = profile_step(lambda: float(step(state, crops, True)[1]["loss"]),
                         "swav_step_trace.json")

    # flat LARS (with the prototype post_apply) vs per-leaf over 3 steps,
    # on one micro-batch's real gradients
    acc = make_swav_accumulate_step(model, cfg)
    grads = zeros_like_grads(state.params)
    grads, _n, _bs, _q, _m = acc(state.params, state.batch_stats, state.queue,
                                 grads, 0, crops, 0, True)
    spec = DeviceFlatPipeline.for_tree(grads).spec
    copies = lambda: TrainState.create(
        {n: p.detach().clone() for n, p in state.params.items()}, tx)
    flat_state, leaf_state = copies(), copies()
    post = make_prototype_post_apply()
    flat = make_flat_apply_step(
        FlatLars(spec, [False] * len(spec), schedule, momentum=0.9, weight_decay=1e-6),
        spec, post_apply=post, from_tree=True)
    leaf = make_guarded_apply_step(tx, post_apply=post)
    flat_worst = 0.0
    for _ in range(3):
        flat_state, ok1 = flat(flat_state, grads)
        leaf_state, ok2 = leaf(leaf_state, grads)
        if not (bool(ok1) and bool(ok2)):
            fail("swav flat/per-leaf apply rejected a finite update")
        for n, ref in leaf_state.params.items():
            err = float((flat_state.params[n] - ref).abs().max() / ref.abs().max())
            flat_worst = max(flat_worst, err)
    if flat_worst > SWAV_FLAT_RTOL:
        fail(f"swav flat LARS {flat_worst:.3e} from the per-leaf apply")
    log(f"  flat LARS vs per-leaf, 3 steps: {flat_worst:.3e} relative (tol {SWAV_FLAT_RTOL})")
    flat_ms = event_ms(lambda: flat(flat_state, grads))
    leaf_ms = event_ms(lambda: leaf(leaf_state, grads))
    del flat_state, leaf_state, grads
    gc.collect()
    torch.cuda.empty_cache()

    # bench.py's B=128, if it fits
    big = dict(batch=SWAV_BENCH_BATCH)
    try:
        crops_big = _swav_crops(SWAV_BENCH_BATCH, seed + 1)
        torch.cuda.reset_peak_memory_stats()
        float(step(state, crops_big, True)[1]["loss"])
        t0 = time.perf_counter()
        loss_big = float(step(state, crops_big, True)[1]["loss"])
        big.update(step_ms=(time.perf_counter() - t0) * 1e3, loss=loss_big,
                   peak_bytes=torch.cuda.max_memory_allocated())
        big["images_per_s"] = SWAV_BENCH_BATCH / big["step_ms"] * 1e3
        log(f"  B={SWAV_BENCH_BATCH}: {json.dumps(big)}")
    except torch.cuda.OutOfMemoryError as e:
        big.update(fits=False, error=str(e).splitlines()[0])
        log(f"  B={SWAV_BENCH_BATCH} does not fit on this card: {big['error']}")
    crops_big = None
    return dict(params=n_params, batch=SWAV_BATCH, crops=[list(c.shape) for c in crops],
                losses=losses, step_ms=step_ms, median_step_ms=med_ms,
                images_per_s=SWAV_BATCH / med_ms * 1e3, peak_bytes=peak,
                bn_running_var_rel_err=var_err, flat_vs_leaf_rel=flat_worst,
                flat_apply_ms=flat_ms, leaf_apply_ms=leaf_ms, trace=trace,
                bench_batch=big)


def swav_cli(seed: int, work: str) -> dict:
    """A solo SwAV peer through ``python -m dedloc_tpu_torch.roles.swav`` at
    full width: 4 boundaries of 32 images, target batch 64 (2 of 4
    boundaries step), queue 3,840 engaged from global step 1."""
    out_dir = os.path.join(work, "swav")
    events_path = os.path.join(work, "swav_events.jsonl")
    cmd = [sys.executable, "-m", "dedloc_tpu_torch.roles.swav",
           "--dht.experiment_prefix", "chip-smoke-swav",
           "--dht.listen_host", "127.0.0.1",
           "--dht.listen_port", str(_free_port()),
           "--training.per_device_batch_size", str(SWAV_BATCH),
           "--training.max_local_steps", str(SWAV_CLI_BOUNDARIES),
           "--training.queue_length", str(SWAV_QUEUE),
           "--training.queue_start_step", "1",
           "--training.seed", str(seed),
           "--training.save_steps", "2", "--training.save_total_limit", "1",
           "--training.output_dir", out_dir,
           "--training.log_every", "1",
           "--optimizer.target_batch_size", str(2 * SWAV_BATCH),
           "--checkpoint.cache_dir", "none",
           "--telemetry.enabled", "true",
           "--telemetry.event_log_path", events_path,
           # a solo peer finds no partner: do not wait 5 s for one
           "--averager.averaging_expiration", "0.5",
           "--averager.min_refresh_period", "0.2",
           "--averager.default_refresh_period", "0.5",
           # a lone peer takes the networked path (the flat apply) until its
           # progress record's lifetime has passed, then applies per leaf
           # with no round: keep the run inside that window
           "--averager.metadata_expiration", "300"]
    log(f"[swav] CLI peer: {' '.join(cmd[3:])}")
    t0 = time.perf_counter()
    with open(os.path.join(work, "swav.log"), "w") as logf:
        proc = subprocess.run(cmd, stdout=logf, stderr=subprocess.STDOUT,
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              timeout=420)
    wall_s = time.perf_counter() - t0
    with open(os.path.join(work, "swav.log")) as f:
        text = f.read()
    if proc.returncode:
        fail(f"swav: the peer exited {proc.returncode}:\n{text[-3000:]}")
    for marker in FALLBACKS:
        if marker in text:
            fail(f"swav: the peer fell back: {marker!r}")
    if "queue engaged" not in text:
        fail(f"swav: the queue never engaged:\n{text[-3000:]}")
    applied = re.findall(r"global step (\d+): loss ([-\d.naif]+) \(apply (\w+), group (\d+)\)",
                         text)
    # the target is 2 boundaries' samples: the 2nd and 4th boundary step
    # when the progress tracker's view keeps up, one boundary later when a
    # boundary is shorter than its refresh period (then 1 of 4)
    if not 1 <= len(applied) <= SWAV_CLI_BOUNDARIES // 2 or any(
            a[2] != "flat" for a in applied):
        fail(f"swav: global steps {applied} (want 1-{SWAV_CLI_BOUNDARIES // 2}, "
             f"all through the flat apply):\n{text[-3000:]}")
    losses = [float(a[1]) for a in applied]
    if not all(math.isfinite(x) for x in losses):
        fail(f"swav: non-finite peer loss {losses}")
    ckpts = sorted(d for d in os.listdir(out_dir) if d.startswith("checkpoint-"))
    if not ckpts:
        fail("swav: the peer saved no checkpoint")
    steps = [e for e in _jsonl(events_path) if e.get("event") == "step.record"]
    if len(steps) != SWAV_CLI_BOUNDARIES:
        fail(f"swav: {len(steps)} step records for {SWAV_CLI_BOUNDARIES} boundaries")
    out = dict(wall_s=wall_s, global_steps=[int(a[0]) for a in applied], losses=losses,
               boundary_ms=[e["dur_s"] * 1e3 for e in steps],
               phases_ms=[{k: v * 1e3 for k, v in e.get("phases", {}).items()}
                          for e in steps],
               checkpoint=os.path.join(out_dir, ckpts[-1]), output_dir=out_dir)
    log(f"  peer: {json.dumps(out)}")
    return out


def swav_probe(seed: int, ckpt_dir: str) -> dict:
    """``run_linear_probe`` on the eval-mode trunk's features of labelled
    synthetic images, from the peer's checkpoint (a check, not a result)."""
    import numpy as np

    from dedloc_tpu_torch.data.multicrop import synthetic_labeled_images
    from dedloc_tpu_torch.finetune import LinearProbeArguments, extract_features, run_linear_probe
    from dedloc_tpu_torch.finetune.linear_probe import swav_trunk_apply
    from dedloc_tpu_torch.models.swav import SwAVConfig, init_swav
    from dedloc_tpu_torch.roles.swav import restore_checkpoint
    from dedloc_tpu_torch.utils.checkpoint import load_latest_checkpoint

    model, params, stats = init_swav(SwAVConfig(), seed + 7, "cuda")
    step, tree, _meta = load_latest_checkpoint(ckpt_dir)
    stats = restore_checkpoint(tree, params, stats)
    images, labels = synthetic_labeled_images(320, size=96, num_classes=8, seed=seed)
    t0 = time.perf_counter()
    feats = extract_features(swav_trunk_apply(model, params, stats), images,
                             batch_size=64, device="cuda")
    extract_s = time.perf_counter() - t0
    if not np.isfinite(feats).all() or feats.shape != (320, 2048):
        fail(f"swav probe: features {feats.shape}, finite {np.isfinite(feats).all()}")
    result = run_linear_probe(feats[:256], labels[:256], feats[256:], labels[256:], 8,
                              LinearProbeArguments(num_epochs=10, batch_size=64,
                                                   learning_rate=0.1), device="cuda")
    log(f"  probe from checkpoint step {step}: {result} (extract {extract_s:.2f} s)")
    return dict(checkpoint_step=step, extract_s=extract_s, **result)


def phase_swav(seed: int) -> dict:
    """The SwAV peer on the card: tiny card vs CPU, the full-width local
    step, the CLI peer and the linear probe. It launches none of the
    port's kernels."""
    from dedloc_tpu_torch.ops import _build
    from dedloc_tpu_torch.ops import flash_attention as fa
    from dedloc_tpu_torch.ops import fused_ln as fl

    t0 = time.perf_counter()
    for w in fa.WRAPPERS + fl.WRAPPERS:
        w.launches = 0
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="swav-", dir=_build.BUILD_DIR)
    try:
        tiny = swav_tiny_card_vs_cpu(seed)
        local = swav_local(seed)
        gc.collect()
        torch.cuda.empty_cache()
        cli = swav_cli(seed, work)
        probe = swav_probe(seed, cli["output_dir"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = _port_launches()
    if any(launches.values()):
        fail(f"swav: the phase launched port kernels {launches}")
    return dict(tiny=tiny, local=local, cli=cli, probe=probe, launches=launches,
                phase_s=time.perf_counter() - t0)


# ---------------------------------------------------------------- phase 10

MOE_EXPERTS = 8  # a Switch Transformer expert count (arXiv 2101.03961)
MOE_CAPACITY = 1.25  # the JAX defaults and the Switch Transformer's
MOE_AUX_WEIGHT = 0.01
MOE_TINY_EXPERTS = 4
# the tokens a routing comparison counts: top-1/top-2 gate margin above
# this; closer pairs may order differently under two fp32 products
MOE_MARGIN = 1e-5
# card vs CPU at the tiny config (bf16): y on tokens both route alike and
# keep, of max |ref|; over MOE_TINY_SEEDS seeds, |loss card - loss cpu| and
# the whole gradient's relative error (the two hidden states differ by bf16
# rounding). The two limits sit 10-15x above the largest reading over seeds
# 0-3 on an H100: 6.7e-6 and 1.38e-3
MOE_Y_TOL = 2e-2
MOE_TINY_SEEDS = 4
MOE_LOSS_TOL = 1e-4
MOE_GRAD_TOL = 1.5e-2
# the full-width cell's routing at init, card against CPU on the same
# weights and tokens, per application of the shared block: the share of
# clear tokens routed alike, |dropped share card - cpu|, |aux| relative.
# After 24 applications the bf16 hidden states of two devices differ by a
# few per cent, and so do the JAX package's and the port's on one CPU
# (tests/test_torch_moe_large.py). Readings on an H100 at seed 0: >= 0.9875,
# <= 0.0013, <= 8.8e-4
MOE_ROUTE_AGREE = 0.95
MOE_DROP_TOL = 0.02
MOE_AUX_REL = 1e-2
# the gateway's fp32 NumPy experts against the bf16 layer on the card
MOE_SERVE_TOL = 2e-2
MOE_SERVE_TOKENS = 256
MOE_CLI_STEPS = 2  # averaged global steps each trainer must take
MOE_CLI_DEADLINE_S = 180.0
MOE_TINY_FLAGS = ["--training.model_size", "tiny",
                  "--training.moe_experts", str(MOE_TINY_EXPERTS),
                  "--training.moe_capacity_factor", str(MOE_CAPACITY),
                  "--training.moe_aux_weight", str(MOE_AUX_WEIGHT)]


def _margins(gates):
    top2 = gates.topk(2, dim=-1).values
    return top2[:, 0] - top2[:, 1]


def moe_ffn_card_vs_cpu(seed: int) -> dict:
    """``moe_ffn`` on the same bf16 tokens and weights on the card and on
    the CPU (tiny widths, 8 x 64 tokens, 4 experts): routing, y and aux."""
    from dedloc_tpu_torch.parallel import moe

    cfg = moe.MoEConfig(hidden_size=32, ffn_size=64, num_experts=MOE_TINY_EXPERTS,
                        capacity_factor=MOE_CAPACITY, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(seed)
    params = moe.init_moe_params(cfg, gen)
    params["router"] = params["router"] * 4.0  # gates away from uniform
    x = torch.randn(8 * 64, 32, generator=gen).to(torch.bfloat16)
    runs = {}
    for device in ("cuda", "cpu"):
        p = {k: v.to(device) for k, v in params.items()}
        xd = x.to(device)
        r = moe.route(p["router"], xd, cfg)
        y, aux = moe.moe_ffn(p, xd, cfg)
        runs[device] = (r, y.float().cpu(), float(aux))
    (rc, yc, aux_c), (rp, yp, aux_p) = runs["cuda"], runs["cpu"]
    clear = _margins(rp.gates) > MOE_MARGIN
    same = (rc.expert.cpu() == rp.expert) & (rc.position.cpu() == rp.position)
    if not bool(same[clear].all()):
        fail(f"moe: card and CPU route {int((~same[clear]).sum())} tokens with "
             f"a gate margin above {MOE_MARGIN} differently")
    both = clear & rp.keep & same
    scale = float(yp.abs().max())
    err = check_close("moe_ffn card vs cpu (kept, clear tokens)", yc[both], yp[both],
                      MOE_Y_TOL * scale, 0.0)
    if abs(aux_c - aux_p) > 1e-5 * abs(aux_p):
        fail(f"moe: aux card {aux_c} vs cpu {aux_p}")
    out = dict(tokens=x.shape[0], clear_share=float(clear.float().mean()),
               routed_alike=int(same.sum()), kept=int(rp.keep.sum()),
               capacity=rp.capacity, max_abs_err=err, max_abs_ref=scale,
               aux_card=aux_c, aux_cpu=aux_p)
    log(f"  moe_ffn card vs cpu: {json.dumps(out)}")
    return out


def _moe_tiny_card_vs_cpu(seed: int) -> dict:
    from dedloc_tpu_torch.roles.common import (
        build_loss_fn, build_model, drop_collator_keys, synthetic_mlm_batches,
    )

    results, batch_np = {}, None
    for device in ("cuda", "cpu"):
        cfg, model = build_model("tiny", remat_policy="fused_ln",
                                 attention_impl="flash", device=device,
                                 seed=seed, moe_experts=MOE_TINY_EXPERTS,
                                 moe_capacity_factor=MOE_CAPACITY,
                                 moe_aux_weight=MOE_AUX_WEIGHT)
        if batch_np is None:
            batch_np = next(synthetic_mlm_batches(cfg, 8, 64, seed))
        params = dict(model.named_parameters())
        loss, metrics = build_loss_fn(model)(params,
                                             drop_collator_keys(batch_np, device))
        grads = torch.autograd.grad(loss, list(params.values()))
        flat = torch.cat([g.float().flatten().cpu() for g in grads])
        results[device] = (float(loss.detach()), float(metrics["moe_aux"].detach()),
                           flat)
    (loss_c, aux_c, g_c), (loss_p, aux_p, g_p) = results["cuda"], results["cpu"]
    rel = float((g_c - g_p).norm() / g_p.norm())
    cos = float(torch.dot(g_c, g_p) / (g_c.norm() * g_p.norm()))
    return dict(seed=seed, loss_card=loss_c, loss_cpu=loss_p, aux_card=aux_c,
                aux_cpu=aux_p, loss_abs_err=abs(loss_c - loss_p),
                grad_rel_err=rel, grad_cosine=cos, grad_elements=g_p.numel())


def moe_model_card_vs_cpu(seed: int) -> dict:
    """The tiny ALBERT-MoE (flash + fused_ln, bf16) from the same weights and
    batch on the card and the CPU, for MOE_TINY_SEEDS seeds: the loss with
    aux, and the whole gradient."""
    runs = [_moe_tiny_card_vs_cpu(seed + i) for i in range(MOE_TINY_SEEDS)]
    out = dict(runs=runs, max_loss_abs_err=max(r["loss_abs_err"] for r in runs),
               max_grad_rel_err=max(r["grad_rel_err"] for r in runs))
    log(f"  tiny ALBERT-MoE card vs cpu: {json.dumps(out)}")
    for r in runs:
        if not (math.isfinite(r["loss_card"]) and r["loss_abs_err"] <= MOE_LOSS_TOL):
            fail(f"moe: tiny loss card {r['loss_card']} vs cpu {r['loss_cpu']} "
                 f"(seed {r['seed']}, tol {MOE_LOSS_TOL})")
        if not r["grad_rel_err"] <= MOE_GRAD_TOL:
            fail(f"moe: tiny whole-gradient relative error {r['grad_rel_err']:.3e} "
                 f"> {MOE_GRAD_TOL} (seed {r['seed']})")
    return out


def moe_routings(model, batch) -> list:
    """One forward of ``model`` on ``batch`` (no gradient): each MoE
    application's routing, on the CPU."""
    from dedloc_tpu_torch.models.albert import recorded_routing

    with recorded_routing(model) as seen, torch.no_grad():
        model(batch["input_ids"], batch["attention_mask"],
              batch["token_type_ids"], mlm_positions=batch["mlm_positions"])
    return [r._replace(**{f: getattr(r, f).cpu() for f in
                          ("gates", "expert", "gate", "position", "keep", "aux")})
            for r in seen]


def routing_summary(seen) -> dict:
    """The share of tokens over capacity and aux, per application and in all."""
    tokens = seen[0].expert.shape[0]
    kept = [int(r.keep.sum()) for r in seen]
    return dict(applications=len(seen), tokens=tokens, capacity=seen[0].capacity,
                dropped_share=1.0 - sum(kept) / (tokens * len(seen)),
                dropped_share_per_application=[1.0 - k / tokens for k in kept],
                busiest_expert_tokens=[
                    int(torch.bincount(r.expert, minlength=r.gates.shape[1]).max())
                    for r in seen],
                aux_per_application=[float(r.aux) for r in seen])


def moe_routing_card_vs_cpu(cfg, seed: int, card_model, batch_np) -> dict:
    """The full-width cell's model at init on the card and on the CPU (the
    same weights from ``seed``, the plain versions of its kernels), one
    forward of the same tokens: per application, the clear tokens routed
    alike, the dropped share and aux. Also the card's routing of the first
    sample alone, the input of ``tests/test_torch_moe_large.py``."""
    from dedloc_tpu_torch.models.albert import AlbertForPreTraining, init_weights
    from dedloc_tpu_torch.roles.common import drop_collator_keys

    card = moe_routings(card_model, drop_collator_keys(batch_np, device="cuda"))
    cpu_model = AlbertForPreTraining(cfg)
    init_weights(cpu_model, torch.Generator().manual_seed(seed))
    t0 = time.perf_counter()
    cpu = moe_routings(cpu_model, drop_collator_keys(batch_np, device="cpu"))
    cpu_s = time.perf_counter() - t0
    del cpu_model
    gc.collect()
    agree, drop_err, aux_rel = [], [], []
    for rc, rp in zip(card, cpu):
        clear = _margins(rp.gates) > MOE_MARGIN
        agree.append(float((rc.expert[clear] == rp.expert[clear]).float().mean()))
        drop_err.append(abs(float(rc.keep.float().mean() - rp.keep.float().mean())))
        aux_rel.append(abs(float(rc.aux) - float(rp.aux)) / float(rp.aux))
    first = {k: v[:1] for k, v in batch_np.items()}
    row0 = routing_summary(moe_routings(
        card_model, drop_collator_keys(first, device="cuda")))
    router = card_model.albert.encoder.layer.block.moe_router
    out = dict(card=routing_summary(card), cpu=routing_summary(cpu),
               cpu_forward_s=cpu_s, clear_routed_alike_per_application=agree,
               dropped_share_abs_err_per_application=drop_err,
               aux_rel_err_per_application=aux_rel, min_routed_alike=min(agree),
               max_dropped_share_abs_err=max(drop_err), max_aux_rel_err=max(aux_rel),
               card_first_sample=row0, router_sum=float(router.detach().double().sum()))
    log(f"  routing at init, card vs cpu: min routed alike {min(agree):.4f}, "
        f"max |dropped share| error {max(drop_err):.4f}, max aux relative error "
        f"{max(aux_rel):.2e} (CPU forward {cpu_s:.1f} s)")
    if min(agree) < MOE_ROUTE_AGREE:
        fail(f"moe: card and CPU route {agree} of the clear tokens alike per "
             f"application (limit {MOE_ROUTE_AGREE})")
    if max(drop_err) > MOE_DROP_TOL:
        fail(f"moe: dropped shares of card and CPU differ by {drop_err} "
             f"(limit {MOE_DROP_TOL})")
    if max(aux_rel) > MOE_AUX_REL:
        fail(f"moe: aux of card and CPU differ by {aux_rel} relative "
             f"(limit {MOE_AUX_REL})")
    return out


def moe_layer_times(seed: int) -> dict:
    """The MoE layer at the full-width cell's shape ([12 x 512, 1024] bf16
    tokens, 8 experts of 1024 -> 4096 -> 1024, C = 960): device time of the
    router, the dispatch, the expert products and the combine, of the layer
    (index dispatch) and of its dense einsum plain version, forward and
    forward + backward; the two held against each other."""
    from dedloc_tpu_torch.parallel import moe

    h, f, t = 1024, 4096, 12 * 512
    cfg = moe.MoEConfig(hidden_size=h, ffn_size=f, num_experts=MOE_EXPERTS,
                        capacity_factor=MOE_CAPACITY, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(seed)
    p = {k: v.cuda() for k, v in moe.init_moe_params(cfg, gen).items()}
    x = torch.randn(t, h, generator=gen).to(torch.bfloat16).cuda()
    r = moe.route(p["router"], x, cfg)
    buf = moe.dispatch(x, r, cfg)
    out = moe.experts(p, buf, cfg.dtype)
    y_i, _ = moe.moe_ffn(p, x, cfg)
    y_d, _ = moe.moe_ffn_dense(p, x, cfg)
    scale = float(y_d.float().abs().max())
    err = float((y_i.float() - y_d.float()).abs().max())
    if not err <= 1e-2 * scale:
        fail(f"moe: index dispatch vs dense plain version {err:.3e} (max |ref| "
             f"{scale:.3e}, tol 1e-2 of it)")
    c = r.capacity
    ms = dict(router=cuda_ms(lambda: moe.route(p["router"], x, cfg)),
              dispatch=cuda_ms(lambda: moe.dispatch(x, r, cfg)),
              experts=cuda_ms(lambda: moe.experts(p, buf, cfg.dtype)),
              combine=cuda_ms(lambda: moe.combine(out, r, cfg)),
              layer=cuda_ms(lambda: moe.moe_ffn(p, x, cfg)),
              plain=cuda_ms(lambda: moe.moe_ffn_dense(p, x, cfg), reps=10, calls=2))
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xg = x.clone().requires_grad_(True)
    dy = torch.randn(t, h, generator=gen).to(torch.bfloat16).cuda()

    def fwd_bwd(fn):
        y, aux = fn(leaves, xg, cfg)
        torch.autograd.backward([y, aux], [dy, torch.ones_like(aux)])

    ms["layer_fwd_bwd"] = event_ms(lambda: fwd_bwd(moe.moe_ffn), reps=5)
    ms["plain_fwd_bwd"] = event_ms(lambda: fwd_bwd(moe.moe_ffn_dense), reps=5)
    expert_flops = 2 * 2 * MOE_EXPERTS * c * h * f
    n_bytes = (2 * t * h * 2 + 2 * MOE_EXPERTS * h * f * 2)  # x, y; wi, wo bf16
    lb = bound(n_bytes, tensor_cores=expert_flops / BF16_FLOPS * 1e3,
               fp32=2 * t * h * MOE_EXPERTS / FP32_FLOPS * 1e3)
    out = dict(tokens=t, capacity=c, ms=ms, max_abs_err_vs_plain=err,
               max_abs_ref=scale, expert_tflops=expert_flops / (ms["experts"] * 1e9),
               bound_ms=lb["bound_ms"], bound_by=lb["bound_by"],
               plain_extra_tflop=2 * 2 * t * MOE_EXPERTS * c * h / 1e12)
    log(f"  MoE layer [{t}, {h}] x {MOE_EXPERTS} experts: {json.dumps(out)}")
    return out


def moe_full_width(seed: int) -> dict:
    """ALBERT-large with 8 experts at 12 x 512, accumulation 2, remat
    fused_ln, flash, LAMB: the routing at init, 3 steps with the launch
    counters checked, one traced step, the routing after."""
    from dedloc_tpu_torch.models.albert import AlbertConfig
    from dedloc_tpu_torch.roles.common import drop_collator_keys, synthetic_mlm_batches

    cfg = AlbertConfig.large(remat_policy="fused_ln", fused_ln=True,
                             attention_impl="flash", moe_experts=MOE_EXPERTS,
                             moe_capacity_factor=MOE_CAPACITY,
                             moe_aux_weight=MOE_AUX_WEIGHT)
    model = _large(cfg, seed)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[moe] ALBERT-large, {MOE_EXPERTS} experts: {n_params} parameters "
        f"({n_params * 2} bytes on the fp16 wire)")
    probe_np = next(synthetic_mlm_batches(cfg, 12, 512, seed + 7))
    probe = drop_collator_keys(probe_np, device="cuda")
    witness = moe_routing_card_vs_cpu(cfg, seed, model, probe_np)
    at_init = witness["card"]
    log(f"  routing at init: {json.dumps({k: v for k, v in at_init.items() if 'per' not in k})}")
    run = run_path("moe", cfg, model, 12, 512, seed, COLLAB_EXPECTED,
                   trace="moe_step_trace.json")
    after = routing_summary(moe_routings(model, probe))
    log(f"  routing after {run['steps'] + 1} steps: "
        f"{json.dumps({k: v for k, v in after.items() if 'per' not in k})}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(run, parameters=n_params, wire_bytes_fp16=2 * n_params,
                routing_at_init=at_init, routing_after=after,
                routing_card_vs_cpu={k: v for k, v in witness.items()
                                     if k not in ("card",)})


def _spawn(cmd, work: str, name: str, env=None):
    logf = open(os.path.join(work, f"{name}.log"), "w")
    proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT, env=env,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, logf


def _tail(work: str, name: str) -> str:
    with open(os.path.join(work, f"{name}.log")) as f:
        return f.read()[-3000:]


def moe_deployment(seed: int, work: str) -> dict:
    """The reference's deployment through the CLIs: a coordinator and an aux
    peer on the CPU (CUDA hidden: host roles hold no tensor on a device),
    two tiny MoE trainers on the card (flash + fused_ln). The coordinator
    comes up first, then the aux (bootstrapping from it); then the trainers,
    started together, each bootstrapping from the coordinator and the other
    trainer (so neither steps alone). Stopped
    (SIGINT) once both trainers took MOE_CLI_STEPS averaged steps, the aux
    joined a round and the coordinator saw both trainers."""
    # a port is taken as late as it can be: a port freed for a child to bind
    # may meanwhile go to a socket of a peer already running. The aux needs
    # no known address and binds its own
    ports = {"coordinator": _free_port()}
    addr = lambda k: f"127.0.0.1:{ports[k]}"
    common = ["--dht.experiment_prefix", "chip-smoke-moe",
              "--dht.listen_host", "127.0.0.1",
              "--optimizer.target_batch_size", "32",
              "--averager.compression", "float16",
              "--averager.min_refresh_period", "0.2",
              "--averager.default_refresh_period", "0.5"]
    host_env = {k: v for k, v in os.environ.items() if k != "DEDLOC_FORCE_CPU"}
    host_env["CUDA_VISIBLE_DEVICES"] = ""
    procs, logs = {}, []
    coord_log = os.path.join(work, "coordinator_metrics.jsonl")
    t_start = time.perf_counter()
    try:
        proc, f = _spawn([sys.executable, "-m", "dedloc_tpu_torch.roles.coordinator",
                          *common, "--dht.listen_port", str(ports["coordinator"]),
                          "--coordinator.refresh_period", "0.5",
                          "--coordinator.metrics_log_path", coord_log,
                          "--coordinator.incident_log_path",
                          os.path.join(work, "coordinator_incidents.jsonl"),
                          "--coordinator.ledger_log_path",
                          os.path.join(work, "coordinator_ledger.jsonl")],
                         work, "coordinator", host_env)
        procs["coordinator"] = proc
        logs.append(f)
        # the DHT root answers before the others bootstrap from it, and the
        # aux is in the DHT before the trainers start their rounds
        up = time.time() + 60
        while "listening on" not in _tail(work, "coordinator"):
            if proc.poll() is not None or time.time() > up:
                fail(f"moe: the coordinator did not come up:\n"
                     f"{_tail(work, 'coordinator')}")
            time.sleep(0.2)
        proc, f = _spawn([sys.executable, "-m", "dedloc_tpu_torch.roles.aux",
                          *common, *MOE_TINY_FLAGS,
                          "--dht.initial_peers", addr("coordinator")],
                         work, "aux", host_env)
        procs["aux"] = proc
        logs.append(f)
        up = time.time() + 60
        while "aux peer DHT listening" not in _tail(work, "aux"):
            if procs["aux"].poll() is not None or time.time() > up:
                fail(f"moe: the aux peer did not come up:\n{_tail(work, 'aux')}")
            time.sleep(0.2)
        ports.update(A=_free_port(), B=_free_port())
        for peer, other in (("A", "B"), ("B", "A")):
            pdir = os.path.join(work, peer)
            os.makedirs(pdir)
            proc, f = _spawn([
                sys.executable, "-m", "dedloc_tpu_torch.roles.trainer", *common,
                *MOE_TINY_FLAGS,
                "--training.remat_policy", "fused_ln",
                "--training.attention_impl", "flash",
                "--training.per_device_batch_size", "8",
                "--training.seq_length", "64",
                "--training.gradient_accumulation_steps", "2",
                "--training.warmup_steps", "0", "--training.seed", str(seed),
                "--training.max_local_steps", "400",
                "--training.save_steps", "1", "--training.save_total_limit", "0",
                "--training.output_dir", pdir,
                "--training.train_log_path", os.path.join(pdir, "train.jsonl"),
                "--optimizer.device_flat", "true", "--optimizer.flat_apply", "true",
                "--checkpoint.cache_dir", "none",
                "--dht.listen_port", str(ports[peer]),
                "--dht.initial_peers", addr("coordinator"), addr(other)],
                work, peer)
            procs[peer] = proc
            logs.append(f)

        def progress():
            steps = {p: [r for r in _jsonl(os.path.join(work, p, "train.jsonl"))
                         if r["group_size"] >= 2] for p in ("A", "B")}
            with open(os.path.join(work, "aux.log")) as fh:
                joined = len(re.findall(r"joined averaging round", fh.read()))
            alive = max((r.get("alive_peers", 0) for r in _jsonl(coord_log)),
                        default=0)
            return steps, joined, alive

        deadline = time.time() + MOE_CLI_DEADLINE_S
        while time.time() < deadline:
            steps, joined, alive = progress()
            if (all(len(v) >= MOE_CLI_STEPS for v in steps.values())
                    and joined >= 1 and alive >= 2):
                break
            for name, pr in procs.items():
                if pr.poll() is not None:
                    fail(f"moe: {name} exited early ({pr.returncode}):\n"
                         f"{_tail(work, name)}")
            time.sleep(1.0)
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
        for f in logs:
            f.close()
    wall_s = time.perf_counter() - t_start
    steps, joined, alive = progress()
    if not all(len(v) >= MOE_CLI_STEPS for v in steps.values()):
        fail(f"moe: averaged steps {({p: [r['step'] for r in v] for p, v in steps.items()})} "
             f"(want {MOE_CLI_STEPS} each); A:\n{_tail(work, 'A')}")
    if joined < 1:
        fail(f"moe: the aux joined no round:\n{_tail(work, 'aux')}")
    if alive < 2:
        fail(f"moe: the coordinator saw {alive} alive peers (want 2):\n"
             f"{_tail(work, 'coordinator')}")
    for peer in ("A", "B"):
        text = _tail(work, peer)
        for marker in FALLBACKS:
            if marker in text:
                fail(f"moe: trainer {peer} fell back: {marker!r}")
    records = {p: _jsonl(os.path.join(work, p, "train.jsonl")) for p in ("A", "B")}
    for p, rs in records.items():
        if not all(math.isfinite(r["loss"]) for r in rs):
            fail(f"moe: trainer {p} non-finite loss")
        if any(r["apply"] != "flat" for r in steps[p]):
            fail(f"moe: trainer {p} averaged steps not through the flat apply")
    common_steps = sorted({r["step"] for r in steps["A"]}
                          & {r["step"] for r in steps["B"]})
    hashes = {}
    for step in common_steps:
        paths = [os.path.join(work, p, f"checkpoint-{step}") for p in ("A", "B")]
        if all(os.path.isdir(x) for x in paths):
            hashes[step] = [_state_hash(x) for x in paths]
    if not hashes:
        fail(f"moe: no averaged step checkpointed by both trainers {common_steps}")
    for step, (a, b) in hashes.items():
        if a != b:
            fail(f"moe: the trainers' states differ after round {step}: {a} {b}")
    last = max(hashes)
    log(f"  trainers bitwise equal after rounds {sorted(hashes)}; aux joined "
        f"{joined}; coordinator saw {alive} alive peers")
    return dict(
        wall_s=wall_s, averaged_steps={p: [r["step"] for r in v] for p, v in steps.items()},
        group_sizes={p: [r["group_size"] for r in v] for p, v in steps.items()},
        losses={p: [r["loss"] for r in rs] for p, rs in records.items()},
        kernel_launches={p: rs[-1]["kernel_launches"] for p, rs in records.items()},
        boundary_ms={p: [r["boundary_ms"] for r in rs] for p, rs in records.items()},
        aux_rounds=joined, coordinator_alive_peers=alive,
        bitwise_after_rounds=sorted(hashes), state_sha256=hashes[last][0],
        checkpoint=os.path.join(work, "A", f"checkpoint-{last}"))


def moe_serving(seed: int, checkpoint: str) -> dict:
    """The trainers' checkpoint served through the swarm: two ``ExpertHost``s
    (experts 0-1, 2-3) run ``ffn_compute_fn`` on its moe_wi / moe_wo in
    NumPy, a ``GatewayService`` holds its moe_router, all on loopback DHTs
    in this process (a serving peer needs no card: that is the design); a
    client's ``gateway.infer`` answers MOE_SERVE_TOKENS seeded bf16 tokens.
    The answer is held against the port's ``moe_ffn`` on the card (bf16
    experts, as the model runs them) on the tokens the layer keeps within
    capacity and routes with a clear margin."""
    import numpy as np

    from dedloc_tpu_torch.core.serialization import (
        CompressionType, deserialize_array, serialize_array,
    )
    from dedloc_tpu_torch.dht import DHT
    from dedloc_tpu_torch.parallel import moe
    from dedloc_tpu_torch.roles.gateway import GatewayService
    from dedloc_tpu_torch.serving import ExpertHost, RouterPolicy, ffn_compute_fn
    from dedloc_tpu_torch.utils.checkpoint import load_checkpoint

    named, _meta = load_checkpoint(checkpoint)
    block = "[0]['albert']['encoder']['layer']['block']"
    w = {k: np.asarray(named[f"{block}['moe_{k}']"], np.float32)
         for k in ("router", "wi", "wo")}
    e, h, f = w["wi"].shape
    cfg = moe.MoEConfig(hidden_size=h, ffn_size=f, num_experts=e,
                        capacity_factor=MOE_CAPACITY, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(MOE_SERVE_TOKENS, h, generator=gen).to(torch.bfloat16)
    x_np = x.float().numpy()
    root = DHT(start=True, listen_host="127.0.0.1")
    peers = [DHT(start=True, listen_host="127.0.0.1",
                 initial_peers=[root.get_visible_address()]) for _ in range(4)]
    hosts, gateway, client = peers[:2], peers[2], peers[3]
    compute = ffn_compute_fn(w)
    half = e // 2

    async def attach_host(node, experts):
        return await ExpertHost(node, "chip-smoke-serve", experts, 1,
                                compute_fn=compute).announce()

    async def attach_gateway(node):
        service = GatewayService(node, "chip-smoke-serve",
                                 policy=RouterPolicy(deadline_s=10.0,
                                                     attempt_timeout_s=5.0),
                                 router_params=w["router"], version=1)
        await service.router.refresh(force=True)
        return service.router.known_experts()

    def infer(i):
        return client.run_coroutine(lambda node: node.client.call(
            gateway.endpoint, "gateway.infer",
            {"tokens": serialize_array(x_np, CompressionType.NONE),
             "request_id": f"req-{i}"}, timeout=30.0))

    try:
        for d, experts in zip(hosts, (list(range(half)), list(range(half, e)))):
            if not d.run_coroutine(lambda node, ex=experts: attach_host(node, ex)):
                fail("moe: an expert host's announce failed")
        known = gateway.run_coroutine(attach_gateway)
        if sorted(known) != list(range(e)):
            fail(f"moe: the gateway knows experts {known}")
        reply = infer(0)
        ms = []
        for i in range(1, 11):
            t0 = time.perf_counter()
            infer(i)
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        for d in peers + [root]:
            d.shutdown()
    y = torch.from_numpy(deserialize_array(reply["data"]))
    p = {"router": torch.from_numpy(w["router"]).cuda(),
         "wi": torch.from_numpy(w["wi"]).cuda().to(torch.bfloat16),
         "wo": torch.from_numpy(w["wo"]).cuda().to(torch.bfloat16)}
    ref, _aux = moe.moe_ffn(p, x.cuda(), cfg)
    ref = ref.float().cpu()
    r = moe.route(p["router"], x.cuda(), cfg)
    use = (r.keep & (_margins(r.gates) > MOE_MARGIN)).cpu()
    scale = float(ref.abs().max())
    err = check_close("gateway.infer vs moe_ffn on the card (kept tokens)",
                      y[use], ref[use], MOE_SERVE_TOL * scale, 0.0)
    if reply["served"] != MOE_SERVE_TOKENS:
        fail(f"moe: the gateway served {reply['served']} of {MOE_SERVE_TOKENS}")
    out = dict(tokens=MOE_SERVE_TOKENS, experts=e, compared=int(use.sum()),
               kept=int(r.keep.sum()), max_abs_err=err, max_abs_ref=scale,
               served=reply["served"], fall_through=reply["fall_through"],
               ms_per_request=statistics.median(ms), ms_requests=ms)
    log(f"  serving: {json.dumps(out)}")
    return out


def phase_moe(seed: int) -> dict:
    """The Switch-MoE ALBERT peer: card vs CPU at tiny widths, the full-width
    cell with its launches, the MoE layer's device time, the deployment
    through the CLIs and the gateway serving its experts."""
    from dedloc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    log("[moe] moe_ffn and tiny ALBERT-MoE: card vs CPU")
    ffn = moe_ffn_card_vs_cpu(seed)
    tiny = moe_model_card_vs_cpu(seed)
    full = moe_full_width(seed)
    layer = moe_layer_times(seed)
    gc.collect()
    torch.cuda.empty_cache()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="moe-", dir=_build.BUILD_DIR)
    try:
        log("[moe] coordinator + 2 MoE trainers + aux through the CLIs")
        deploy = moe_deployment(seed, work)
        log("[moe] the trainers' experts served through a gateway")
        serve = moe_serving(seed, deploy.pop("checkpoint"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(ffn_card_vs_cpu=ffn, tiny_card_vs_cpu=tiny, full_width=full,
                layer=layer, deployment=deploy, serving=serve,
                phase_s=time.perf_counter() - t0)


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

    script_t0 = time.perf_counter()

    smi = phase_device()
    build_s, build_regs = phase_build()
    kernels = phase_kernels(args.seed)
    phase_reference(args.seed)
    path = phase_path(args.seed)
    longctx = phase_longctx(args.seed)
    collab = phase_collab(args.seed)
    downstream = phase_downstream(args.seed)
    swav = phase_swav(args.seed)
    moe = phase_moe(args.seed)

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
            # the downstream phase's trainer peer (4 boundaries) and its
            # in-process flash evaluation (8 batches)
            rows[-1]["launches_downstream_trainer"] = \
                downstream["trainer"]["kernel_launches"][name]
            rows[-1]["launches_downstream_eval"] = \
                downstream["eval"]["launches"][name]
            # the Switch-MoE cell's run (3 steps) and its two CLI trainers
            rows[-1]["launches_moe"] = moe["full_width"]["launches"][name]
            rows[-1]["launches_moe_trainers"] = sum(
                v[name] for v in moe["deployment"]["kernel_launches"].values())
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
    print(json.dumps({"downstream": downstream}))
    print(json.dumps({"swav": swav}))
    print(json.dumps({"moe": moe}))
    print(json.dumps({"script_s": time.perf_counter() - script_t0}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
