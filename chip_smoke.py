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
              standard deviation 4); the causal two-width kernels at the
              Moonlight cell's [2, 8192, 16], q/k 192 and v 128 wide (their
              plain versions 4 heads at a time), and one micro-step of a
              3-layer Moonlight-16B-A3B model at that shape with the launch
              counters reset just before (one launch of each kernel a
              layer; the expert row kernels 2/2/1/3/1 an expert layer).
              The expert layer's row kernels (gather, SwiGLU and its
              backward, combine and its backward, the gather's backward)
              at the cell's T = 16,384, k = 6, H = 2,048, F = 1,408 with
              8 of 64 experts held: each against its plain version on the
              live rows, timed beside its bytes. The KDA chunk kernels
              (``ops/csrc/kda.cu``) at the Kimi cell's [2, 8192, 32, 128]
              against their fp32 mirror (2% of max |ref|, 1% relative L2),
              two backward runs bitwise equal, each timed beside its
              ``portbench/counts/kda.py`` bound, and one micro-step of a
              4-layer Kimi-Linear-48B-A3B model (3 KDA + 1 MLA) with the
              launch counters reset just before (each KDA layer: 4 forward
              kernel launches with the recompute, 2 backward). The flash tolerance
              scales with each sample's own max |ref|; the mean signed error toward |ref|
              shows a bias that the tolerance would pass. Device time per
              call (CUDA-graph replays between CUDA events, median) of the
              kernel, the plain version and, where one exists, the one
              PyTorch call computing the same function (timed only, never
              used by the port; for add+LN the nearest calls: the fp32 add
              then native_layer_norm, and native_layer_norm_backward).
              The batch-norm kernels at the SwAV cell's shapes (stem and
              stage-0 conv3x3 at 224, stage-0 expand + residual at 224,
              stage-3 expand + residual at 96, the head): each wrapper
              against its plain twin from the same inputs, its CUDA-graph
              time beside bytes / 3.35 TB/s and beside the native call
              nearest to it (torch.batch_norm_stats, F.batch_norm,
              torch.batch_norm_backward_reduce and _elemt, timed only);
              the launches are the swav phase's.
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
9. swav       the SwAV peer, whose batch norms run the batch-norm
              kernels (each wrapper 107 launches a step: 53 trunk norms a
              crop group and the head's) and which launches no flash or
              add+LN kernel (their counters must stay 0): the tiny config (bf16 trunk)
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

11. mesh     the ALBERT slice on a torch.distributed mesh, ranks sharing
              this card over gloo (every collective staged through pinned
              host memory; NCCL refuses two ranks on one device), each
              launch through torchrun (this script as the ranks,
              ``--mesh-worker``): dp2, tp2, ZeRO-1, pp2, ep2 (8 experts),
              the ring at 1 x 8,192 and tp2 in fp32 on 2 ranks, dp2 x tp2
              on 4; ALBERT-large at 12 x 512, accumulation 2, remat
              fused_ln, flash, LAMB, 2 steps each against the one-rank step
              on the same weights and global batch (MLM loss before the
              first update, the whole gradient, or for TP the distance to
              the fp32 step's gradient), replicated blocks bitwise equal
              across ranks, launches per rank, ms per step, staged bytes and
              peak memory per rank. The SwAV slice on 2 ranks
              (``swav_dp2_fp32``, then ``swav_dp2`` with the bf16 trunk):
              ResNet-50 SwAV, 32 images a step (16 a rank), queue 3,840 on
              the second step, LARS with the prototype post_apply, 2 steps
              against the one-rank step on the same weights and crops (fp32
              with TF32 off: the loss before the first update, the whole
              gradient and the new running statistics; bf16: the gradient's
              distance beside the bf16-vs-fp32 floor measured in the same
              run), params, running statistics and queue bitwise equal
              across the ranks after each step, no port kernel launched.
              Then two torchrun slices (tp2) as two peers through the
              trainer CLI: 3 averaged steps each, states bitwise equal at
              every common checkpointed step, the checkpoint a one-device
              peer's (names, shapes, loads). The SwAV peer as a dp2 slice
              through its CLI (3 boundaries, a solo peer): finite losses,
              its checkpoint loads into a one-device peer. Two dp2 slices
              as peers with overlap averaging: 3 averaged steps each, at
              least one late apply each (telemetry), states bitwise equal
              at every common checkpointed step, the overlap ledger's
              hidden and exposed seconds.

12. tools    the port's tensor tools on the card: ``graft_entry``
              ``dryrun_multichip(4)`` with 4 ranks sharing the card over
              gloo (tiny ALBERT over a (1, 2, 2) data x model x seq mesh:
              forward, backward, accumulation of 2, LAMB, then the ZeRO-1
              apply; pipeline dp2 x pp2, experts dp2 x ep2, the role-MoE
              slice, and two 2-rank collaborative slices, tp2 and pp2,
              forming a group of 2): finite loss, step 1, ZeRO step 2 on
              every rank. Then ``tools/profile_albert.py`` ``peak`` and
              ``pieces`` at [12, 512, 16, 64] (its JSON rows on stdout), the
              launch counters reset before and read after: flash forward
              and backward and add+LN forward and backward each launched.

Prints a ``{"build": ...}`` line, a ``{"kernels": [...]}`` line, a
``{"path": ...}`` line, a ``{"longctx": ...}`` line, a ``{"collab": ...}``
line, a ``{"downstream": ...}`` line, a ``{"swav": ...}`` line, a
``{"moe": ...}`` line, a ``{"mesh": ...}`` line, a ``{"tools": ...}``
line, the whole
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
import random
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

from dedloc_tpu_torch.tools.profile_albert import cuda_ms, event_ms, profile_step
from dedloc_tpu_torch.tools.word_corpus import WORDS

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
MLA_SHAPE = (2, 8192, 16, 192, 128)  # B, S, H, D_QK, D_V of the Moonlight cell
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
BUILT = ("flash_attention", "kda")  # the sources under ops/csrc/
LN_SRC = "dedloc_tpu_torch/ops/fused_ln.py"
FLASH_PY = "dedloc_tpu/ops/flash_attention.py"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


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
    instance (``flash_bwd_dq_kernel<64>``, ``kda_bwd_intra_kernel``), the
    registers a thread is launched with and the bytes ptxas spills
    (stores)."""
    from dedloc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    for source in BUILT:
        _build.build(source)
    seconds = time.perf_counter() - t0
    log(f"[build] nvcc {', '.join(s + '.cu' for s in BUILT)}: {seconds:.1f} s")
    # one line per kernel instance: registers and spills (ptxas -v); and
    # any ptxas warning (a serialised wgmma pipeline says so there)
    name, spill_bytes, regs = "?", 0, {}
    for line in "\n".join(_build.build_log(s) for s in BUILT).splitlines():
        entry = re.search(r"Compiling entry function '.*?(flash_[a-z_]+_kernel)I((?:L[ib]\d+E)+)",
                          line)
        plain = re.search(r"Compiling entry function '.*?(kda_(?:fwd|bwd)_(?:intra|state)_kernel)",
                          line)
        if entry:  # <D>, or <D_QK,D_V,causal> for the two-width kernels
            args = ",".join(re.findall(r"L[ib](\d+)E", entry.group(2)))
            name = f"{entry.group(1)}<{args}>"
        elif plain:
            name = plain.group(1)
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


def _check_flash(tag, q, k, v, dout, bias, group=None, causal=False) -> dict:
    """Every flash kernel against its plain version (run ``group`` heads at
    a time when given); per kernel, the max abs err over the batch and, per
    output, the samples-with-keys statistics. ``causal``: the causal
    kernels (v may then be narrower than q and k)."""
    import functools

    from dedloc_tpu_torch.ops import flash_attention as fa

    run = lambda fn: functools.partial(fn, causal=causal)
    plain = (lambda fn, *a: by_heads(run(fn), group, *a)) if group else (
        lambda fn, *a: run(fn)(*a))
    real = bias.amax(dim=1) == 0  # samples with at least one key
    out, lse = fa.flash_fwd(q, k, v, bias, causal)
    out_p, lse_p = plain(fa.flash_fwd_plain, q, k, v, bias)
    o = check_per_sample(f"{tag} flash_fwd out", out, out_p, real)
    check_close(f"{tag} flash_fwd lse", lse, lse_p, 1e-3, 1e-5)
    del out_p, lse_p
    # the backward kernels on identical inputs (the kernel forward's lse)
    delta = fa.softmax_delta(out, dout)
    dk, dv = fa.flash_bwd_dkdv(q, k, v, bias, lse, dout, delta, causal)
    dk_p, dv_p = plain(fa.flash_bwd_dkdv_plain, q, k, v, bias, lse, dout, delta)
    dq = fa.flash_bwd_dq(q, k, v, bias, lse, dout, delta, causal)
    dq_p = plain(fa.flash_bwd_dq_plain, q, k, v, bias, lse, dout, delta)
    gk = check_per_sample(f"{tag} flash_bwd dk", dk, dk_p, real)
    gv = check_per_sample(f"{tag} flash_bwd dv", dv, dv_p, real)
    gq = check_per_sample(f"{tag} flash_bwd dq", dq, dq_p, real)
    # the autograd operator end to end, with a fixed random cotangent
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    grads = torch.autograd.grad(fa.flash_attention(qr, kr, vr, bias, causal=causal),
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


def _check_repeat(tag, q, k, v, bias, lse, dout, delta, causal=False) -> bool:
    """Two launches of each flash kernel on the same inputs give
    bitwise-equal outputs (every output row has one owner, no atomics)."""
    from dedloc_tpu_torch.ops import flash_attention as fa

    def launch():
        return (*fa.flash_fwd(q, k, v, bias, causal),
                *fa.flash_bwd_dkdv(q, k, v, bias, lse, dout, delta, causal),
                fa.flash_bwd_dq(q, k, v, bias, lse, dout, delta, causal))

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


def _mla_rows(gen, seed: int) -> list:
    """The causal two-width flash kernels (latent attention) at the
    Moonlight cell's shape: each against its plain version 4 heads at a
    time, two launches bitwise equal, then timed beside its bound, in which
    only the (query, key) pairs at or below the diagonal are charged. Then
    one micro-step of a 3-layer Moonlight-16B-A3B model (1 dense + 2 expert
    layers, 8 experts held, 20,480 ids) at the cell's [2, 8192], the launch
    counters reset just before it: one launch of each kernel a layer (the
    recompute keeps flash's out and lse). One row per kernel."""
    from dedloc_tpu_torch.ops import expert_rows as er
    from dedloc_tpu_torch.ops import flash_attention as fa
    from dedloc_tpu_torch.parallel.train_step import make_accumulate_step, zeros_like_grads
    from dedloc_tpu_torch.roles.common import build_loss_fn, build_model

    b, s, h, dqk, dv = MLA_SHAPE
    log(f"[kernels] causal flash attention at [{b}, {s}, {h}], q/k {dqk} and v {dv} "
        "wide, bf16")
    q, k = (torch.randn((b, s, h, dqk), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    v, dout = (torch.randn((b, s, h, dv), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(2))
    bias = torch.zeros((b, s), device="cuda")
    errs = _check_flash(f"MLA S={s}", q, k, v, dout, bias, group=4, causal=True)
    out, lse = fa.flash_fwd(q, k, v, bias, True)
    delta = fa.softmax_delta(out, dout)
    bitwise = _check_repeat(f"MLA S={s}", q, k, v, bias, lse, dout, delta, causal=True)

    def plain_ms(fn, *a):
        return event_ms(lambda: by_heads(lambda *x: fn(*x, causal=True), 4, *a))

    pairs = b * h * s * (s + 1) // 2  # at or below the diagonal
    qk, vo, rows = b * s * h * dqk * 2, b * s * h * dv * 2, b * h * s * 4

    def least(n_bytes, ops_per_pair):
        return bound(n_bytes, tensor_cores=pairs * ops_per_pair / BF16_FLOPS * 1e3,
                     mufu_exp=pairs / EXP_PER_S * 1e3)

    tol = "atol 1e-2 max|ref[b]| for each sample b + rtol 1e-2 |ref|"
    common = dict(route="cuda", source=FLASH_SRC, path=f"Moonlight S={s}",
                  shape=[b, s, h, dqk, dv], tol=tol, replaces="none (no causal or "
                  "two-width attention in the JAX package)", library_ms=None,
                  plain_timing="CUDA events around the loop over 4 head groups",
                  bitwise_repeat=bitwise)
    result = [
        dict(name="flash_fwd", kernel=f"flash_mla_fwd_kernel<{dqk},{dv},1>",
             err=errs["flash_fwd"],
             ms=cuda_ms(lambda: fa.flash_fwd(q, k, v, bias, True), 5, 2),
             plain_ms=plain_ms(fa.flash_fwd_plain, q, k, v, bias),
             **least(2 * qk + 2 * vo + rows, 2 * dqk + 2 * dv),
             tensor_flops=pairs * (2 * dqk + 2 * dv), **common),
        dict(name="flash_bwd_dkdv", kernel=f"flash_mla_bwd_dkdv_kernel<{dqk},{dv},1>",
             err=errs["flash_bwd_dkdv"],
             ms=cuda_ms(lambda: fa.flash_bwd_dkdv(q, k, v, bias, lse, dout, delta, True),
                        5, 2),
             plain_ms=plain_ms(fa.flash_bwd_dkdv_plain, q, k, v, bias, lse, dout, delta),
             **least(3 * qk + 3 * vo + 2 * rows, 4 * dqk + 4 * dv),
             tensor_flops=pairs * (4 * dqk + 4 * dv), **common),
        dict(name="flash_bwd_dq", kernel=f"flash_mla_bwd_dq_kernel<{dqk},{dv},1>",
             err=errs["flash_bwd_dq"],
             ms=cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, bias, lse, dout, delta, True),
                        5, 2),
             plain_ms=plain_ms(fa.flash_bwd_dq_plain, q, k, v, bias, lse, dout, delta),
             **least(3 * qk + 2 * vo + 2 * rows, 4 * dqk + 2 * dv),
             tensor_flops=pairs * (4 * dqk + 2 * dv), **common),
    ]
    del q, k, v, dout, out, lse, delta
    gc.collect()
    torch.cuda.empty_cache()

    layers = 3
    cfg, model = build_model("moonlight-16b-a3b", device="cuda", seed=seed,
                             overrides=dict(num_hidden_layers=layers, vocab_size=20480,
                                            experts_held=8))
    params = dict(model.named_parameters())
    step = make_accumulate_step(build_loss_fn(model))
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    batch = {"input_ids": ids, "labels": torch.roll(ids, -1, 1)}
    wrappers = (fa.flash_fwd, fa.flash_bwd_dkdv, fa.flash_bwd_dq)
    for w in wrappers + er.WRAPPERS:
        w.launches = 0
    _acc, _n, metrics = step(params, zeros_like_grads(params), 0, batch)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    rows_launches = {w.__name__: w.launches for w in er.WRAPPERS}
    if not bool(torch.isfinite(metrics["loss"])):
        fail(f"Moonlight micro-step: loss {float(metrics['loss'])}")
    if set(launches.values()) != {layers}:
        fail(f"Moonlight micro-step at [{b}, {s}], {layers} layers: launches {launches}")
    # an expert layer: gather, SwiGLU and combine in the forward and again
    # in the recompute; the combine's, SwiGLU's and gather's (an ungated
    # combine) backward
    moe_layers = layers - cfg.first_k_dense_replace
    want = dict(expert_gather=2, swiglu_rows=2, swiglu_rows_bwd=1, expert_combine=3,
                expert_combine_bwd=1)
    if rows_launches != {name: n * moe_layers for name, n in want.items()}:
        fail(f"Moonlight micro-step: expert row kernels launched {rows_launches}")
    launches.update(rows_launches)
    log(f"[kernels] Moonlight micro-step at [{b}, {s}], {layers} layers: launches "
        f"{launches}, loss {float(metrics['loss']):.4f}")
    del model, params, step, _acc, metrics
    counts = dict(launches=launches, launches_per_step=launches)
    for row in result:
        row["launch_counts"] = counts
    return result


# the Moonlight cell's expert layer on one rank: T = 2 x 8,192 tokens, k of
# E experts, N held, hidden H, expert width F
MOE_ROWS = dict(T=16384, K=6, E=64, N=8, H=2048, F=1408)
ROWS_SRC = "dedloc_tpu_torch/ops/expert_rows.py"
ROWS_KERNELS = dict(expert_gather="_gather_kernel", swiglu_rows="_swiglu_kernel",
                    swiglu_rows_bwd="_swiglu_bwd_kernel", expert_combine="_combine_kernel",
                    expert_combine_bwd="_combine_bwd_kernel",
                    gather_bwd="_combine_kernel (no gates)")


def expert_rows_rows(gen) -> list:
    """The expert layer's row kernels at the Moonlight cell's shape with a
    live share near 1/8 (each token's k experts uniform over the E, the
    first N held): each against its plain version on the live rows, then
    timed by CUDA-graph replay beside its bytes (each input byte the live
    rows need read once, each output byte written once) and the plain
    version's time (CUDA events: it reads the live count on the host). The
    launches are the Moonlight micro-step's (``_mla_rows``)."""
    from dedloc_tpu_torch.ops import expert_rows as er
    from dedloc_tpu_torch.parallel.moe import sort_pairs

    t, k, e, n, h, f = (MOE_ROWS[c] for c in "TKENHF")
    experts = torch.rand(t, e, generator=gen, device="cuda").topk(k, dim=-1).indices
    pairs = sort_pairs(experts, 0, n)
    live = int(pairs.offs[-1])
    tokens = int((experts < n).any(-1).sum())  # tokens with a held pair
    log(f"[kernels] expert rows at T={t}, k={k}, H={h}, F={f}: {live} of {t * k} "
        f"rows live ({live / (t * k):.4f}), {tokens} tokens")
    x = torch.randn(t, h, generator=gen, device="cuda")
    gates = torch.rand(t, k, generator=gen, device="cuda")
    hh = torch.randn(t * k, 2 * f, generator=gen, device="cuda").bfloat16()
    dact = torch.randn(t * k, f, generator=gen, device="cuda").bfloat16()
    out = torch.randn(t * k, h, generator=gen, device="cuda").bfloat16()
    dy = torch.randn(t, h, generator=gen, device="cuda")
    order, offs = pairs.order, pairs.offs
    rows, inverse = er.expert_gather(x, order, offs, k, torch.bfloat16)
    rows_p, inverse_p = er.expert_gather_plain(x, order, offs, k, torch.bfloat16)
    if not (torch.equal(inverse, inverse_p) and torch.equal(rows[:live], rows_p[:live])):
        fail("expert gather differs from its plain version")
    bf16_tol, fp32_tol = 2 ** -7, 1e-4  # of max |ref|
    close = lambda name, got, want, tol: check_close(
        f"expert rows {name}", got, want, tol * float(want.float().abs().max()), 0.0)
    d_out, d_gates = er.expert_combine_bwd(out, inverse, offs, gates, dy)
    d_out_p, d_gates_p = er.expert_combine_bwd_plain(out, inverse, offs, gates, dy)
    errs = dict(
        expert_gather=0.0,
        swiglu_rows=close("swiglu", er.swiglu_rows(hh, offs)[:live],
                          er.swiglu_rows_plain(hh, offs)[:live], bf16_tol),
        swiglu_rows_bwd=close("swiglu bwd", er.swiglu_rows_bwd(hh, dact, offs)[:live],
                              er.swiglu_rows_bwd_plain(hh, dact, offs)[:live], bf16_tol),
        expert_combine=close("combine", er.expert_combine(out, inverse, offs, gates,
                                                          torch.float32),
                             er.expert_combine_plain(out, inverse, offs, gates,
                                                     torch.float32), fp32_tol),
        expert_combine_bwd=max(close("combine d_out", d_out[:live], d_out_p[:live],
                                     bf16_tol),
                               close("combine d_gates", d_gates, d_gates_p, fp32_tol)),
        gather_bwd=close("gather bwd", er.expert_combine(out, inverse, offs, None,
                                                         torch.float32),
                         er.expert_combine_plain(out, inverse, offs, None, torch.float32),
                         fp32_tol),
    )
    del rows_p, inverse_p, d_out_p, d_gates_p
    index = t * k * (8 + 4)  # order read, inverse written (or read) once
    calls = dict(
        expert_gather=(lambda: er.expert_gather(x, order, offs, k, torch.bfloat16),
                       lambda: er.expert_gather_plain(x, order, offs, k, torch.bfloat16),
                       tokens * h * 4 + live * h * 2 + index),
        swiglu_rows=(lambda: er.swiglu_rows(hh, offs),
                     lambda: er.swiglu_rows_plain(hh, offs), live * f * (4 + 2)),
        swiglu_rows_bwd=(lambda: er.swiglu_rows_bwd(hh, dact, offs),
                         lambda: er.swiglu_rows_bwd_plain(hh, dact, offs),
                         live * f * (4 + 2 + 4)),
        expert_combine=(lambda: er.expert_combine(out, inverse, offs, gates, torch.float32),
                        lambda: er.expert_combine_plain(out, inverse, offs, gates,
                                                        torch.float32),
                        live * h * 2 + t * h * 4 + t * k * (4 + 4)),
        expert_combine_bwd=(lambda: er.expert_combine_bwd(out, inverse, offs, gates, dy),
                            lambda: er.expert_combine_bwd_plain(out, inverse, offs, gates,
                                                                dy),
                            t * h * 4 + live * h * (2 + 2) + t * k * (4 + 4 + 4)),
        gather_bwd=(lambda: er.expert_combine(out, inverse, offs, None, torch.float32),
                    lambda: er.expert_combine_plain(out, inverse, offs, None,
                                                    torch.float32),
                    live * h * 2 + t * h * 4 + t * k * 4),
    )
    result = []
    for name, (kernel, plain, n_bytes) in calls.items():
        result.append(dict(
            name=name, kernel=ROWS_KERNELS[name],
            route="triton", source=ROWS_SRC, path="Moonlight expert layer",
            replaces="none (the JAX package has no dropless expert layer)",
            shape=[t, k, h, f, n], live_rows=live, live_share=live / (t * k),
            err=(errs[name], None), tol="atol 2^-7 (bf16) or 1e-4 (fp32) x max |ref|",
            ms=cuda_ms(kernel), plain_ms=event_ms(plain), plain_timing="CUDA events",
            library_ms=None, bytes=n_bytes, **bound(n_bytes)))
        log(f"  expert rows {name}: {result[-1]['ms']:.4f} ms (bound "
            f"{result[-1]['bound_ms']:.4f}, plain {result[-1]['plain_ms']:.4f})")
    return result


# the Kimi cell's KDA chunk op: [B, S, H, d_k = d_v] at chunks of 16
KDA_SHAPE = (2, 8192, 32, 128)
KDA_SRC = "dedloc_tpu_torch/ops/csrc/kda.cu"
KDA_LAYERS = 4  # the micro-step's model: one period, 3 KDA + 1 MLA


def _kda_inputs(b, s, h, d, gen):
    """q, k L2-normalised and v in bf16; the decay as the Kimi cell's
    initial weights give it (``A_log`` log U(1, 16), up to ~1.6 a token on
    the fastest channels); β in (0, 1); dO in bf16."""
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    q = torch.nn.functional.normalize(rnd(b, s, h, d), dim=-1).bfloat16()
    k = torch.nn.functional.normalize(rnd(b, s, h, d), dim=-1).bfloat16()
    v = rnd(b, s, h, d).bfloat16()
    a = torch.exp(torch.rand(h, 1, generator=gen, device="cuda") * 2.77)
    g = (-a * torch.nn.functional.softplus(rnd(b, s, h, d) * 0.5 - 4.0)).contiguous()
    beta = torch.rand(b, s, h, generator=gen, device="cuda")
    return q, k, v, g, beta, rnd(b, s, h, d).bfloat16()


def kda_rows(gen, seed: int) -> list:
    """The KDA chunk kernels at the Kimi cell's shape: the forward and
    backward against their plain mirror (``kda_fwd_plain`` and
    ``kda_bwd_plain``: the same algorithm in fp32 on the bf16-rounded
    inputs), two backward runs bitwise equal, then each kernel timed by
    CUDA-graph replay beside its ``portbench/counts/kda.py`` bound (each
    operand read once and each output written once, the chunk states
    included) and the mirror's time. Then one micro-step of a 4-layer
    Kimi-Linear-48B-A3B model (3 KDA + 1 MLA, 8 experts held, 20,480 ids)
    at the cell's [2, 8192], the launch counters reset just before it: each
    KDA layer runs the two forward kernels in the forward and again in the
    recompute, and the two backward kernels once. One row per kernel."""
    from dedloc_tpu_torch.ops import kda
    from dedloc_tpu_torch.parallel.train_step import make_accumulate_step, zeros_like_grads
    from dedloc_tpu_torch.roles.common import build_loss_fn, build_model
    from portbench.counts import kda as kda_counts

    b, s, h, d = KDA_SHAPE
    log(f"[kernels] KDA chunk at [{b}, {s}, {h}], d_k = d_v = {d}, chunks of {kda.CHUNK}")
    q, k, v, g, beta, do = _kda_inputs(b, s, h, d, gen)
    scale = d ** -0.5
    o, norm, saved = kda.kda_fwd(q, k, v, g, beta, scale)
    grads = kda.kda_bwd(q, k, v, g, beta, scale, saved, do)
    again = kda.kda_bwd(q, k, v, g, beta, scale, saved, do)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(x, y) for x, y in zip(grads, again))
    if not bitwise:
        fail("KDA backward: two runs differ")
    del again
    plain = [x.float() for x in (q, k, v, g, beta)]

    # every product with the state rounds its operands to bf16 (2^-9
    # relative) and sums in fp32, and the recurrence is contractive: within
    # 2% of the tensor's largest value and 1% in relative L2 (the card
    # test's tolerance)
    def close(name, got, want):
        got, want = got.float(), want.float()
        err = float((got - want).abs().max())
        rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
        if not (bool(torch.isfinite(got).all()) and err <= 2e-2 * float(want.abs().max())
                and rel <= 1e-2):
            fail(f"KDA {name}: max err {err}, rel L2 {rel}")
        return err

    with torch.no_grad():
        o_p, norm_p, saved_p = kda.kda_fwd_plain(*plain, scale)
        errs = dict(kda_fwd=max(close("o", o, o_p), close("norm", norm, norm_p)))
        grads_p = kda.kda_bwd_plain(*plain, scale, saved_p, do.float())
        errs["kda_bwd"] = max(close(n, x, y) for n, x, y in
                              zip(("dq", "dk", "dv", "dg", "dbeta"), grads, grads_p))
        del o_p, norm_p, grads_p
        # the mirror a kernel at a time: its chunked inputs, then each piece
        cq, ck, cv, cg, cb, cdo = (kda._chunked(x, kda.CHUNK) for x in (*plain, do))
        n = cq.shape[2]
        big_g = cg.cumsum(-2)
        s0_p, u_p, m_p, w_p = saved_p
        _g, _a, _m, _t, _w, ut_p = kda._per_group(kda._fwd_intra, n, kda.GROUP, cq, ck, cv,
                                                   cg, cb)
        ds_p, du_p = kda._bwd_states(cq, ck, big_g, w_p, m_p, cdo, scale)
        plain_calls = dict(
            kda_fwd_intra=lambda: kda._per_group(kda._fwd_intra, n, kda.GROUP, cq, ck, cv,
                                                 cg, cb),
            kda_fwd_state=lambda: kda._fwd_states(cq, ck, big_g, w_p, ut_p, m_p, scale),
            kda_bwd_state=lambda: kda._bwd_states(cq, ck, big_g, w_p, m_p, cdo, scale),
            kda_bwd_intra=lambda: kda._per_group(
                lambda *a: kda._bwd_intra(*a, scale), n, kda.GROUP, cq, ck, cv, cg, cb,
                s0_p, ds_p, u_p, du_p, cdo),
        )
        plain_ms = {name: event_ms(fn, 1) for name, fn in plain_calls.items()}
    del plain_calls, saved_p, s0_p, u_p, m_p, w_p, ut_p, ds_p, du_p, cq, ck, cv, cg, cb, cdo
    gc.collect()
    torch.cuda.empty_cache()
    s0, u, m, w = saved
    ss = torch.empty(b * h, d // kda.BV, device="cuda")
    dh, du = torch.empty_like(s0), torch.empty_like(u)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dg, dbeta = torch.empty_like(g), torch.empty_like(beta)
    calls = dict(
        kda_fwd_intra=lambda: kda.launch_fwd_intra(q, k, v, g, beta, w, u, m),
        kda_fwd_state=lambda: kda.launch_fwd_state(q, k, g, w, u, m, o, s0, ss, scale),
        kda_bwd_state=lambda: kda.launch_bwd_state(q, k, g, w, m, do, dh, du, scale),
        kda_bwd_intra=lambda: kda.launch_bwd_intra(q, k, v, g, beta, s0, dh, u, du, do, dq,
                                                   dk, dv, dg, dbeta, scale),
    )
    counted = kda_counts.counts(b, s, h, d, d, kda.CHUNK)
    result = []
    for name, fn in calls.items():
        kernel = f"{name}_kernel"
        n_bytes, macs = counted[kernel]
        result.append(dict(
            name=name, kernel=kernel, route="cuda", source=KDA_SRC,
            path="Kimi Linear KDA", replaces="none (the JAX package has no linear-attention "
            "layer)", shape=[b, s, h, d, d, kda.CHUNK],
            err=(errs["kda_fwd" if "fwd" in name else "kda_bwd"], None),
            tol="2% of max |ref| and 1% relative L2, against the fp32 mirror",
            bitwise_repeat=bitwise, ms=cuda_ms(fn, 10, 2), plain_ms=plain_ms[name],
            plain_timing="CUDA events, the mirror's piece for this kernel",
            library_ms=None, bytes=n_bytes, tensor_flops=2 * macs,
            **bound(n_bytes, tensor_cores=2 * macs / BF16_FLOPS * 1e3)))
        log(f"  {name}: {result[-1]['ms']:.4f} ms (bound {result[-1]['bound_ms']:.4f}, "
            f"{100 * result[-1]['bound_ms'] / result[-1]['ms']:.1f}%; plain "
            f"{result[-1]['plain_ms']:.1f})")
    del q, k, v, g, beta, do, o, norm, saved, grads, s0, u, m, w, ss, dh, du, dq, dk, dv
    del dg, dbeta, calls
    gc.collect()
    torch.cuda.empty_cache()

    cfg, model = build_model("kimi-linear-48b-a3b", device="cuda", seed=seed,
                             moe_experts_held=8,
                             overrides=dict(num_hidden_layers=KDA_LAYERS, vocab_size=20480))
    params = dict(model.named_parameters())
    step = make_accumulate_step(build_loss_fn(model))
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    batch = {"input_ids": ids, "labels": torch.roll(ids, -1, 1)}
    n_kda = sum(cfg.is_kda(i) for i in range(KDA_LAYERS))
    kda.kda_fwd.launches = kda.kda_bwd.launches = 0
    _acc, _n, metrics = step(params, zeros_like_grads(params), 0, batch)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(metrics["loss"])):
        fail(f"Kimi micro-step: loss {float(metrics['loss'])}")
    # two kernels a wrapper call: the forward's in the forward and the
    # recompute, the backward's once
    got = dict(kda_fwd=kda.kda_fwd.launches, kda_bwd=kda.kda_bwd.launches)
    if got != dict(kda_fwd=2 * 2 * n_kda, kda_bwd=2 * n_kda):
        fail(f"Kimi micro-step, {n_kda} KDA layers: launches {got}")
    launches = dict(kda_fwd_intra=got["kda_fwd"] // 2, kda_fwd_state=got["kda_fwd"] // 2,
                    kda_bwd_state=got["kda_bwd"] // 2, kda_bwd_intra=got["kda_bwd"] // 2)
    log(f"[kernels] Kimi micro-step at [{b}, {s}], {KDA_LAYERS} layers ({n_kda} KDA): "
        f"launches {launches}, loss {float(metrics['loss']):.4f}")
    del model, params, step, _acc, metrics
    counts = dict(launches=launches, launches_per_step=launches)
    for row in result:
        row["launch_counts"] = counts
    return result


MT_SRC = "dedloc_tpu_torch/ops/multi_tensor.py"
MT_KERNELS = dict(sumsq="_sq_kernel + _leaf_sums_kernel",
                  all_finite="_sq_kernel + _leaf_sums_kernel",
                  scaled_copy="_copy_kernel", lamb_norms="_lamb_kernel + _leaf_sums_kernel",
                  lamb_candidate="_lamb_kernel", lamb_commit="_lamb_kernel",
                  lars_norms="_lars_kernel + _leaf_sums_kernel",
                  lars_candidate="_lars_kernel", lars_commit="_lars_kernel")
# bytes an element each wrapper must move: each operand read once, each
# output written once (the per-chunk partials and per-leaf scalars aside)
MT_BYTES = dict(sumsq=4, all_finite=4, scaled_copy=8, lamb_norms=16, lamb_candidate=20,
                lamb_commit=28, lars_norms=8, lars_candidate=16, lars_commit=24)


def _cell_leaves(cell: str) -> list:
    """The parameter shapes of the Moonlight cell (10 layers, 8 of 64
    experts, vocabulary 20,480) or of the SwAV cell (ResNet-50, 3,000
    prototypes), from models built on the meta device."""
    from dedloc_tpu_torch.models.swav import SwAVConfig, SwAVModel
    from dedloc_tpu_torch.roles.common import build_model

    if cell == "moonlight":
        _cfg, model = build_model("moonlight-16b-a3b", device="meta", moe_experts_held=8,
                                  overrides=dict(num_hidden_layers=10, vocab_size=20480))
    else:
        with torch.device("meta"):
            model = SwAVModel(SwAVConfig())
    return [tuple(p.shape) for p in model.parameters()]


def multi_tensor_rows(gen) -> list:
    """The boundary's multi-tensor passes (``ops/multi_tensor.py``) over
    the Moonlight cell's 130 leaves (1.07 B parameters) and the SwAV
    cell's 166 (28.4 M): each wrapper against its plain version on the same
    tensors (the commits on copies of the state: LAMB's at both sizes,
    LARS's at SwAV's), then timed by CUDA-graph replay beside its bytes
    (each operand read once, each output written once) and the plain
    version's time (CUDA events).
    The whole boundary (the mean, then a LAMB or LARS apply with the
    guard) is timed too."""
    from dedloc_tpu_torch.collaborative.optimizer import _fused_mean_clip
    from dedloc_tpu_torch.ops import multi_tensor as mt
    from dedloc_tpu_torch.optim.lamb import Lamb, LambState
    from dedloc_tpu_torch.optim.lars import Lars, LarsState

    result = []
    for cell in ("moonlight", "swav"):
        shapes = _cell_leaves(cell)
        n = sum(math.prod(s) for s in shapes)
        table = mt.LeafTable([math.prod(s) for s in shapes],
                             [len(s) > 1 for s in shapes])
        draw = lambda scale: [torch.randn(s, generator=gen, device="cuda") * scale
                              for s in shapes]
        g, p, mu, nu = draw(1e-3), draw(0.02), draw(1e-4), draw(1e-4)
        nu = [v.abs_() for v in nu]
        out = table.empty_like(p)
        b = table.bind([g, p, mu, nu, out])
        lb = table.bind([g, p, mu, out])
        cb = table.bind([g, out])
        log(f"[kernels] multi-tensor passes, {cell}: {len(shapes)} leaves, {n:,} "
            f"parameters, {table.n_chunks:,} chunks, vec {b.vec}")
        lamb = Lamb(2.2e-4, weight_decay=0.1, max_grad_norm=1.0)
        lars = Lars(0.3, weight_decay=1e-6)
        g_norm = torch.sqrt(mt.sumsq_plain(g).sum())
        bc1, bc2 = (torch.full((), v, device="cuda") for v in (0.1, 0.000999500166))
        neg_lr = torch.full((), -2.2e-4, device="cuda")
        ratio = torch.rand(len(table), generator=gen, device="cuda") + 0.5
        neg_rate = -torch.rand(len(table), generator=gen, device="cuda") * 1e-3
        yes = torch.ones((), dtype=torch.bool, device="cuda")

        def rel(name, got, want):
            got, want = got.float(), want.float()
            err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
            if not err <= 1e-5:
                fail(f"multi-tensor {cell} {name}: {err:.3e} relative (tol 1e-5)")
            return err

        def leaves_rel(name, got, want):
            return max(rel(name, x, y) for x, y in zip(got, want))

        errs = dict(
            sumsq=rel("sumsq", mt.sumsq(b, mt.G), mt.sumsq_plain(g)),
            lamb_norms=rel("lamb norms", mt.lamb_norms(b, lamb, g_norm, bc1, bc2),
                           mt.lamb_norms_plain(b, lamb, g_norm, bc1, bc2)),
            lars_norms=rel("lars norms", mt.lars_norms(lb, lars),
                           mt.lars_norms_plain(lb, lars.weight_decay)),
        )
        if not bool(mt.all_finite(b, mt.G)):
            fail(f"multi-tensor {cell}: all_finite False on finite leaves")
        g[-1].view(-1)[-1] = float("nan")
        if bool(mt.all_finite(b, mt.G)):
            fail(f"multi-tensor {cell}: all_finite True with a NaN in the last leaf")
        g[-1].view(-1)[-1] = 0.0
        errs["all_finite"] = 0.0
        want = table.empty_like(p)
        mt.scaled_copy(cb, 3)
        mt.scaled_copy_plain(g, want, 3)
        if not all(torch.equal(x, y) for x, y in zip(out, want)):
            fail(f"multi-tensor {cell}: the mean's division differs from the plain one")
        errs["scaled_copy"] = 0.0
        mt.lamb_candidate(b, lamb, g_norm, bc1, bc2, neg_lr, ratio)
        mt.lamb_candidate_plain(table.bind([g, p, mu, nu, want]), lamb, g_norm, bc1,
                                bc2, neg_lr, ratio)
        errs["lamb_candidate"] = leaves_rel("lamb candidate", out, want)
        mt.lars_candidate(lb, lars, neg_rate)
        mt.lars_candidate_plain(table.bind([g, p, mu, want]), lars, neg_rate)
        errs["lars_candidate"] = leaves_rel("lars candidate", out, want)
        del want
        # the commits on two copies of the state (at Moonlight's size 26 GB
        # beside the 21 GB bound above); LARS's at SwAV's size alone
        copies = lambda: [[t.clone() for t in r] for r in (p, mu, nu)]
        (p1, mu1, nu1), (p2, mu2, nu2) = copies(), copies()
        mt.lamb_commit(table.bind([g, p1, mu1, nu1, out]), lamb, g_norm, yes)
        mt.lamb_commit_plain(table.bind([g, p2, mu2, nu2, out]), lamb, g_norm, yes)
        errs["lamb_commit"] = max(leaves_rel("lamb commit", x, y)
                                  for x, y in ((p1, p2), (mu1, mu2), (nu1, nu2)))
        if cell == "swav":
            mt.lars_commit(table.bind([g, p1, mu1, out]), lars, neg_rate, yes)
            mt.lars_commit_plain(table.bind([g, p2, mu2, out]), lars, neg_rate, yes)
            errs["lars_commit"] = max(leaves_rel("lars commit", x, y)
                                      for x, y in ((p1, p2), (mu1, mu2)))
        del p1, mu1, nu1, p2, mu2, nu2
        calls = dict(
            sumsq=(lambda: mt.sumsq(b, mt.G), lambda: mt.sumsq_plain(g)),
            all_finite=(lambda: mt.all_finite(b, mt.G), lambda: mt.all_finite_plain(g)),
            scaled_copy=(lambda: mt.scaled_copy(cb, 3),
                         lambda: mt.scaled_copy_plain(g, out, 3)),
            lamb_norms=(lambda: mt.lamb_norms(b, lamb, g_norm, bc1, bc2),
                        lambda: mt.lamb_norms_plain(b, lamb, g_norm, bc1, bc2)),
            lamb_candidate=(lambda: mt.lamb_candidate(b, lamb, g_norm, bc1, bc2, neg_lr,
                                                      ratio),
                            lambda: mt.lamb_candidate_plain(b, lamb, g_norm, bc1, bc2,
                                                            neg_lr, ratio)),
            lamb_commit=(lambda: mt.lamb_commit(b, lamb, g_norm, yes),
                         lambda: mt.lamb_commit_plain(b, lamb, g_norm, yes)),
            lars_norms=(lambda: mt.lars_norms(lb, lars),
                        lambda: mt.lars_norms_plain(lb, lars.weight_decay)),
            lars_candidate=(lambda: mt.lars_candidate(lb, lars, neg_rate),
                            lambda: mt.lars_candidate_plain(lb, lars, neg_rate)),
            lars_commit=(lambda: mt.lars_commit(lb, lars, neg_rate, yes),
                         lambda: mt.lars_commit_plain(lb, lars, neg_rate, yes)),
        )
        big = cell == "moonlight"
        for name, (kernel, plain) in calls.items():
            n_bytes = MT_BYTES[name] * n
            result.append(dict(
                name=name, kernel=MT_KERNELS[name], route="triton", source=MT_SRC,
                path=f"{cell} boundary", replaces="none (the JAX package leaves the "
                "update to XLA)", shape=[len(shapes), n], err=(errs.get(name), None),
                tol="1e-5 of max |ref| (scaled_copy bitwise)",
                ms=cuda_ms(kernel, 5, 2) if big else cuda_ms(kernel),
                plain_ms=event_ms(plain), plain_timing="CUDA events", library_ms=None,
                bytes=n_bytes, **bound(n_bytes)))
            log(f"  {cell} {name}: {result[-1]['ms']:.4f} ms (bound "
                f"{result[-1]['bound_ms']:.4f}, plain {result[-1]['plain_ms']:.4f})")
        # the whole boundary as the cells run it, timed between CUDA events
        from dedloc_tpu_torch.averaging.device_flat import DeviceFlatPipeline
        from dedloc_tpu_torch.optim.flat import flat_twin
        from dedloc_tpu_torch.parallel.train_step import TrainState, make_flat_apply_step

        del out, b, lb, cb
        # Linear and Conv2d weights (a permuted wire layout, weight decay),
        # biases, and the experts' stacks
        kinds = {1: "bias", 2: "weight", 4: "weight"}
        names = [f"l{i:03d}.{kinds.get(len(s), 'proj')}" for i, s in enumerate(shapes)]
        params = dict(zip(names, p))
        acc = dict(zip(names, g))
        tx = lamb if big else lars
        state = TrainState(step=0, params=params, opt_state=(
            LambState(count=0, mu=dict(zip(names, mu)), nu=dict(zip(names, nu)),
                      schedule_count=0) if big
            else LarsState(momentum=dict(zip(names, mu)), schedule_count=0)))
        spec = DeviceFlatPipeline.for_tree(acc).spec
        apply = make_flat_apply_step(flat_twin(tx, spec, params), spec,
                                     post_apply=lambda st: st, from_tree=True)
        cap = 0.0 if big else 256.0

        def boundary():
            nonlocal state
            state, ok = apply(state, _fused_mean_clip(acc, 2, cap))
            return ok

        before = {w.__name__: w.launches for w in mt.WRAPPERS}
        ok = boundary()
        torch.cuda.synchronize()
        launches = {w.__name__: w.launches - before[w.__name__] for w in mt.WRAPPERS}
        if not bool(ok):
            fail(f"multi-tensor {cell}: the boundary's apply rejected a finite step")
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        ms = event_ms(boundary)
        extra = torch.cuda.max_memory_allocated() - held
        per = sum(MT_BYTES[k] * v for k, v in launches.items()) * n
        result.append(dict(
            name="boundary", kernel="mean clip + " + ("LAMB" if big else "LARS") + " apply",
            route="triton", source=MT_SRC, path=f"{cell} boundary", replaces="none",
            shape=[len(shapes), n], err=(None, None), tol=None, ms=ms,
            plain_ms=None, plain_timing="CUDA events (host launches included)",
            library_ms=None, bytes=per, launches=launches,
            extra_bytes_per_param=extra / n, **bound(per)))
        log(f"  {cell} boundary: {ms:.3f} ms (bound {result[-1]['bound_ms']:.3f}), "
            f"launches {launches}, {extra / n:.3f} B a parameter beyond the state")
        del state, params, acc, g, p, mu, nu, apply
        gc.collect()
        torch.cuda.empty_cache()
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
    # a generator of its own, so that the cases after it draw what they drew
    # before it was added
    results += _mla_rows(torch.Generator(device="cuda").manual_seed(seed + 1), seed)
    gc.collect()
    torch.cuda.empty_cache()
    results += expert_rows_rows(torch.Generator(device="cuda").manual_seed(seed + 2))
    gc.collect()
    torch.cuda.empty_cache()
    results += kda_rows(torch.Generator(device="cuda").manual_seed(seed + 4), seed)
    gc.collect()
    torch.cuda.empty_cache()
    results += multi_tensor_rows(torch.Generator(device="cuda").manual_seed(seed + 3))
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
    gc.collect()
    torch.cuda.empty_cache()
    results += batch_norm_rows(gen)
    torch.cuda.synchronize()
    return results


# the SwAV cell's batch norms (128 images: 2 x 224^2 + 6 x 96^2 crops):
# (tag, input shape, residual, output dtype); every one ReLU-ended, the
# head's input fp32, the trunk's bf16 (its convolutions' output)
BN_CASES = (
    ("stem 224", (256, 64, 112, 112), False, torch.float32),
    ("stage0 conv3x3 224", (256, 64, 56, 56), False, torch.bfloat16),
    ("stage0 expand 224", (256, 256, 56, 56), True, torch.float32),
    ("stage3 expand 96", (768, 2048, 3, 3), True, torch.float32),
    ("head", (1024, 2048), False, torch.float32),
)
BN_SRC = "dedloc_tpu_torch/ops/batch_norm.py"
BN_FP32_TOL = 1e-5  # of each output's max |ref|: fp32 sums in other orders
BN_BF16_TOL = 2 ** -7  # one bf16 step (2^-8) of max |ref|, and as much again
# share of elements whose ReLU mask may differ between kernel and twin: a
# pre-activation within an fp32 rounding of 0 (the kernel fuses a multiply
# and add the twin rounds twice)
BN_MASK_SHARE = 1e-5


def _bn_case(tag, shape, res, out_dtype, gen) -> list:
    """The four batch-norm wrappers against their plain twins from the same
    inputs (each fed the kernel's own statistics and mask, so a row checks
    one kernel), then each timed by CUDA-graph replay beside its bytes."""
    from dedloc_tpu_torch.ops import batch_norm as bn

    c = shape[1]
    x_dtype = torch.float32 if len(shape) == 2 else torch.bfloat16
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(x_dtype)
    if len(shape) == 4:
        x = x.contiguous(memory_format=torch.channels_last)
    x2 = x.permute(0, 2, 3, 1).reshape(-1, c) if len(shape) == 4 else x
    m = x2.shape[0]
    vec = lambda base, scale: base + scale * torch.randn(c, generator=gen, device="cuda")
    w, b, ra_m, ra_v = vec(1.0, 0.1), vec(0.0, 0.1), vec(0.0, 0.1), vec(1.0, 0.1).abs()
    r2 = torch.randn((m, c), generator=gen, device="cuda") if res else None
    dy = torch.randn((m, c), generator=gen, device="cuda").to(out_dtype)
    eps = 1e-5
    log(f"[kernels] batch norm {tag}: [{m}, {c}] {x_dtype} -> {out_dtype}, "
        f"ReLU{' + residual' if res else ''}")
    tol = lambda dtype: BN_BF16_TOL if dtype == torch.bfloat16 else BN_FP32_TOL
    close = lambda name, got, want, dtype: check_close(
        f"{tag} {name}", got, want, tol(dtype) * float(want.float().abs().max()), 0.0)

    st, nm, nv = bn.bn_stats(x2, ra_m, ra_v, 0.9)
    st_p, nm_p, nv_p = bn.bn_stats_plain(x2, ra_m, ra_v, 0.9)
    stats_err = max(close("stats mean", st[:c], st_p[:c], torch.float32),
                    close("stats var", st[c:2 * c], st_p[c:2 * c], torch.float32),
                    close("running mean", nm, nm_p, torch.float32),
                    close("running var", nv, nv_p, torch.float32))
    if float(st[2 * c]) != m:
        fail(f"batch norm {tag}: row count {float(st[2 * c])} != {m}")
    mean, var, count = st[:c], st[c:2 * c], st[2 * c:]
    y, mask = bn.bn_apply(x2, mean, var, w, b, eps, True, r2, out_dtype, with_mask=res)
    y_p, mask_p = bn.bn_apply_plain(x2, mean, var, w, b, eps, True, r2, out_dtype,
                                    with_mask=res)
    apply_err = close("apply y", y, y_p, out_dtype)
    flips = 0
    if res:
        flips = int((mask != mask_p).sum())
        if flips > BN_MASK_SHARE * mask.numel():
            fail(f"batch norm {tag}: {flips} ReLU mask bytes differ")
    d = bn.bn_grad_sums(x2, dy, mask, mean, var, w, b, eps, True)
    d_p = bn.bn_grad_sums_plain(x2, dy, mask, mean, var, w, b, eps, True)
    sums_err = max(close("dbias", d[:c], d_p[:c], torch.float32),
                   close("dweight", d[c:], d_p[c:], torch.float32))
    dx, dr = bn.bn_dx(x2, dy, mask, mean, var, count, w, b, d, eps, True,
                      None if r2 is None else r2.dtype)
    dx_p, dr_p = bn.bn_dx_plain(x2, dy, mask, mean, var, count, w, b, d, eps, True,
                                None if r2 is None else r2.dtype)
    if not res:
        # the ReLU recomputed from x: leave out the elements whose
        # pre-activation lies within an fp32 rounding of 0
        pre = (x2.float() - mean) * (torch.rsqrt(var.clamp_min(0) + eps) * w) + b
        edge = pre.abs() <= 1e-6 * float(pre.abs().max())
        flips = int(edge.sum())
        if flips > BN_MASK_SHARE * edge.numel():
            fail(f"batch norm {tag}: {flips} pre-activations at 0")
        dx, dx_p = dx.masked_fill(edge, 0), dx_p.masked_fill(edge, 0)
    dx_err = close("dx", dx, dx_p, x_dtype)
    if res:
        dx_err = max(dx_err, close("dresidual", dr, dr_p, torch.float32))
    del y_p, mask_p, dx_p, dr_p
    gc.collect()

    xb, ob = x2.element_size(), y.element_size()
    n = m * c
    mask_b = n if res else 0
    bytes_ = dict(
        bn_stats=n * xb,
        bn_apply=n * (xb + ob) + (n * 4 if res else 0) + mask_b,
        bn_grad_sums=n * (xb + ob) + mask_b,
        bn_dx=n * (xb + ob + xb) + mask_b + (n * 4 if res else 0),
    )
    calls = dict(
        bn_stats=(lambda: bn.bn_stats(x2, ra_m, ra_v, 0.9),
                  lambda: bn.bn_stats_plain(x2, ra_m, ra_v, 0.9), stats_err),
        bn_apply=(lambda: bn.bn_apply(x2, mean, var, w, b, eps, True, r2, out_dtype, res),
                  lambda: bn.bn_apply_plain(x2, mean, var, w, b, eps, True, r2,
                                            out_dtype, res), apply_err),
        bn_grad_sums=(lambda: bn.bn_grad_sums(x2, dy, mask, mean, var, w, b, eps, True),
                      lambda: bn.bn_grad_sums_plain(x2, dy, mask, mean, var, w, b, eps,
                                                    True), sums_err),
        bn_dx=(lambda: bn.bn_dx(x2, dy, mask, mean, var, count, w, b, d, eps, True,
                                None if r2 is None else r2.dtype),
               lambda: bn.bn_dx_plain(x2, dy, mask, mean, var, count, w, b, d, eps, True,
                                      None if r2 is None else r2.dtype), dx_err),
    )
    # the nearest PyTorch calls, timed only and never called by the port,
    # on the same input and gradient (x's dtype and layout; no ReLU and no
    # residual): F.batch_norm in training mode (statistics and normalise in
    # one call) beside bn_stats + bn_apply, and the native kernels of
    # SyncBatchNorm for the statistics and the two backward passes
    xs = x if len(shape) == 4 else x2
    dys = dy.to(x_dtype)
    if len(shape) == 4:
        n_, _, h_, w_ = shape
        dys = dys.view(n_, h_, w_, c).permute(0, 3, 1, 2)
    lib_mean, lib_invstd = torch.batch_norm_stats(xs, eps)
    lib_sums = torch.batch_norm_backward_reduce(dys, xs, lib_mean, lib_invstd, w,
                                                True, True, True)
    lib_count = torch.full((1,), m, dtype=torch.int32, device="cuda")
    library = dict(
        bn_stats=(lambda: torch.batch_norm_stats(xs, eps),
                  "torch.batch_norm_stats (mean, invstd; no running statistics)"),
        bn_apply=(lambda: torch.nn.functional.batch_norm(
            xs, None, None, w, b, training=True, eps=eps),
                  "F.batch_norm training (one call: statistics + normalise, "
                  "no epilogue), beside bn_stats + bn_apply"),
        bn_grad_sums=(lambda: torch.batch_norm_backward_reduce(
            dys, xs, lib_mean, lib_invstd, w, True, True, True),
                      "torch.batch_norm_backward_reduce (no ReLU mask)"),
        bn_dx=(lambda: torch.batch_norm_backward_elemt(
            dys, xs, lib_mean, lib_invstd, w, lib_sums[0], lib_sums[1], lib_count),
               "torch.batch_norm_backward_elemt (no ReLU mask, no residual "
               "gradient)"),
    )
    rows = []
    for name, (kernel, plain, err) in calls.items():
        rows.append(dict(
            name=name, replaces="none (flax nn.BatchNorm, left to XLA)",
            route="triton", source=BN_SRC, path="SwAV", case=tag,
            shape=[m, c], x_dtype=str(x_dtype), out_dtype=str(out_dtype),
            residual=res, err=(err, None), mask_edge_elements=flips,
            tol="atol 1e-5 (fp32) or 2^-7 (bf16) x max |ref|",
            ms=cuda_ms(kernel), plain_ms=cuda_ms(plain, reps=10, calls=3),
            plain_timing="CUDA graph",
            library_ms=cuda_ms(library[name][0], reps=10, calls=3),
            library=library[name][1], **bound(bytes_[name])))
        log(f"  {tag} {name}: {rows[-1]['ms']:.4f} ms (bound {rows[-1]['bound_ms']:.4f}, "
            f"plain {rows[-1]['plain_ms']:.4f}, library {rows[-1]['library_ms']:.4f})")
    return rows


def batch_norm_rows(gen) -> list:
    """The batch-norm kernels at the SwAV cell's shapes (``BN_CASES``)."""
    rows = []
    for case in BN_CASES:
        rows += _bn_case(*case, gen)
        gc.collect()
        torch.cuda.empty_cache()
    return rows


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
FALLBACKS = ("falling back to the host flatten path",)


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


_PORTS_GIVEN: set = set()


def _free_port() -> int:
    """A free TCP port for a peer to listen on, taken outside the kernel's
    ephemeral range where one is left: an ephemeral port found free here
    can be handed to another process's connection (gloo, torchrun's store)
    before the peer binds it."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low, high = (int(x) for x in f.read().split())
    except (OSError, ValueError):
        low, high = 32768, 60999
    spans = [r for r in ((10000, low - 1), (high + 1, 65535)) if r[1] - r[0] > 1000]
    rng = random.Random()
    for _ in range(200 if spans else 0):
        port = rng.randint(*rng.choice(spans))
        if port in _PORTS_GIVEN:
            continue
        with socket.socket() as sock:
            try:
                sock.bind(("127.0.0.1", port))
            except OSError:
                continue
        _PORTS_GIVEN.add(port)
        return port
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
           "--optimizer.device_flat", "true",
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
def downstream_shards(seed: int, work: str) -> tuple:
    """Stdlib docstrings (``data/corpus.py``) -> word ids -> MLM+SOP
    instances at S=512 (``data/prepare.py``) -> shards (``data/disk.py``):
    every tenth document held out (``tools/word_corpus.py``). Returns
    (counts and paths, the vocabulary, the documents)."""
    from dedloc_tpu_torch.tools.word_corpus import stdlib_documents, write_word_shards

    t0 = time.perf_counter()
    docs = stdlib_documents()
    harvest_s = time.perf_counter() - t0
    out, vocab = write_word_shards(docs, work, DOWN_SEQ, 30000, seed)
    out["harvest_s"] = harvest_s
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
        words = WORDS.findall(sent)
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


def downstream_finetune(seed: int, vocab, docs: list,
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
                 if 4 <= len(WORDS.findall(s)) <= 60]
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

    ncc_examples = [{"text": s, "label": len(WORDS.findall(s)) % 6}
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
# batch norms a SwAV step runs: 53 in the trunk per crop group (2), the
# head's one; each launches every batch-norm wrapper once a step
SWAV_BATCH_NORMS = 53 * 2 + 1
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
    from dedloc_tpu_torch.ops import batch_norm as bnops
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
    losses, step_ms, per_step = [], [], []
    for w in bnops.WRAPPERS:
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i, use_queue in enumerate([False] * SWAV_LOCAL_STEPS[0] + [True] * SWAV_LOCAL_STEPS[1]):
        before = {w.__name__: w.launches for w in bnops.WRAPPERS}
        t0 = time.perf_counter()
        state, metrics = step(state, crops, use_queue)
        loss = float(metrics["loss"])  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        per_step.append({w.__name__: w.launches - before[w.__name__]
                         for w in bnops.WRAPPERS})
        if set(per_step[-1].values()) != {SWAV_BATCH_NORMS}:
            fail(f"swav local step {i}: batch-norm launches {per_step[-1]}, "
                 f"expected {SWAV_BATCH_NORMS} each")
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
    launches = {w.__name__: w.launches for w in bnops.WRAPPERS}
    log(f"  local steps: losses {losses}, ms {[round(t, 2) for t in step_ms]}, "
        f"peak {peak:,} bytes, batch-norm launches per step {per_step[-1]}")
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
                bench_batch=big, launches=launches, launches_per_step=per_step[-1])


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
           # a lone peer takes the networked path (the device-flat wire)
           # until its progress record's lifetime has passed, then steps
           # with no round; both apply flat. Keep the run inside that window
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
    """The probe tool (``tools/swav_probe.py`` ``probe_checkpoint``) on the
    peer's checkpoint: ``run_linear_probe`` on the eval-mode trunk's
    features of labelled synthetic images (a check, not a result)."""
    import numpy as np

    from dedloc_tpu_torch.data.multicrop import synthetic_labeled_images
    from dedloc_tpu_torch.finetune import LinearProbeArguments
    from dedloc_tpu_torch.models.swav import SwAVConfig
    from dedloc_tpu_torch.tools.swav_probe import probe_checkpoint

    images, labels = synthetic_labeled_images(320, size=96, num_classes=8, seed=seed)
    out = probe_checkpoint(ckpt_dir, images, labels, 8, cfg=SwAVConfig(),
                           seed=seed + 7, batch_size=64, device="cuda",
                           probe_args=LinearProbeArguments(num_epochs=10, batch_size=64,
                                                           learning_rate=0.1),
                           random_trunk=False)
    feats = out["features"]
    if not np.isfinite(feats).all() or feats.shape != (320, 2048):
        fail(f"swav probe: features {feats.shape}, finite {np.isfinite(feats).all()}")
    result = {k[len("trained_trunk_"):]: v for k, v in out.items()
              if k.startswith("trained_trunk_top_")}
    log(f"  probe from checkpoint step {out['checkpoint_step']}: {result} "
        f"(extract {out['trained_trunk_extract_s']:.2f} s)")
    return dict(checkpoint_step=out["checkpoint_step"],
                extract_s=out["trained_trunk_extract_s"], **result)


def phase_swav(seed: int) -> dict:
    """The SwAV peer on the card: tiny card vs CPU, the full-width local
    step, the CLI peer and the linear probe. Its batch norms run the
    port's batch-norm kernels; it launches no flash or add+LN kernel."""
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
        fail(f"swav: the phase launched flash or add+LN kernels {launches}")
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
                "--optimizer.device_flat", "true",
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


# ----------------------------------------------------------------- phase 11

# the slice mesh: ranks time-share the one card over gloo (NCCL refuses two
# ranks on one device), so these runs check layouts and numerics, and their
# times are not scaling numbers
MESH_BATCH, MESH_SEQ = 12, 512  # the path phase's micro-batch, accumulation 2
# sp=2: the longest sequence two ranks hold with remat on one 80 GB card
# (PERF.md, Findings: a ring block's fp32 scores are B x 16 x (S/2)^2 x 4
# bytes, ~1.1 GB at 8,192, several live per block in the backward)
RING_SEQ = 8192
MESH_CONFIGS = {
    "dp2": dict(axes=("data",), shape=(2,)),
    "tp2": dict(axes=("data", "model"), shape=(1, 2)),
    "zero": dict(axes=("data",), shape=(2,), zero=True),
    "pp2": dict(axes=("data", "pipe"), shape=(1, 2)),
    "ep2": dict(axes=("data", "expert"), shape=(1, 2), moe=8),
    "ring": dict(axes=("data", "seq"), shape=(1, 2), seq=RING_SEQ, batch=1),
    # TP's arithmetic at full width, without bf16: held to the fp32 step
    "tp2_fp32": dict(axes=("data", "model"), shape=(1, 2), fp32=True),
    "dp2tp2": dict(axes=("data", "model"), shape=(2, 2)),
}
# launches per optimizer step (accumulation 2) per rank: one device runs
# 24 applications per micro-batch; dp/tp/ep ranks run all 24 on their rows
# or heads; a pipe rank runs its 12 on each of the 4 microbatches
# (pipe_microbatches 0 = 2 x stages) of each micro-batch; the ring runs
# plain attention blocks and only the add+LN kernel
MESH_EXPECTED = {
    "default": {"flash_fwd": 48, "flash_bwd_dkdv": 48, "flash_bwd_dq": 48,
                "ln_fwd": 96, "ln_bwd": 96},
    "pp2": {"flash_fwd": 96, "flash_bwd_dkdv": 96, "flash_bwd_dq": 96,
            "ln_fwd": 192, "ln_bwd": 192},
    "ring": {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0,
             "ln_fwd": 96, "ln_bwd": 96},
    "tp2_fp32": {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0,
                 "ln_fwd": 0, "ln_bwd": 0},
}
# the MLM loss before the first update against the one-rank step's (the
# ranks' sums reach the loss in another order): 1e-3 at first, tightened to
# 15x the largest reading of PR 9 (6.6e-6, the ring)
MESH_LOSS_RTOL = 1e-4
# the whole gradient's relative error (||g - g_ref|| / ||g_ref||) against
# the one-rank step, for the axes that keep each product's sum whole (dp,
# ZeRO, pp, ep): 1.5e-2 at first (the MoE phase's card-vs-CPU limit),
# tightened to ~2x the largest reading of PR 9 (5.5e-3, dp2)
MESH_GRAD_RTOL = 1e-2
# TP splits the sums of the row-parallel products, so every activation
# rounds to bf16 from another fp32 order than on one rank. At init the bf16
# gradient is 5.6e-2 from the fp32 one, and a one-rank step whose products
# accumulate in fp32 and round once is already 1.6e-2 from the bf16 one
# (PERF.md §6): above MESH_GRAD_RTOL with no fault. So a bf16 TP cell is
# held to a share of the one-rank step's own distance to fp32 (PR 9 read
# 0.39 and 0.29 of it), and TP's arithmetic to the fp32 step in fp32
# (tp2_fp32; PR 9 read 2.24e-6, so ~10x that)
MESH_TP_NOISE_SHARE = 0.6
MESH_FP32_GRAD_RTOL = 2e-5
MESH_CLI_STEPS = 3  # averaged global steps the two CLI slices must take
MESH_CLI_DEADLINE_S = 240.0
OVERLAP_CLI_STEPS = 3  # averaged steps each overlapping dp2 slice must take
# 3 boundaries of each slice a step, 6 of one alone. A slice applies a
# landed round at its next boundary, up to a boundary before its partner,
# and keeps the samples it accumulated in flight: at a 48-sample target it
# can reach the next round's target before its partner reports the new
# step, average alone and stay one apply ahead (at 48 the states of one
# run differed from step 4 on). The tp2 slices' synchronous rounds apply on
# both at once.
OVERLAP_CLI_TARGET = 144
SWAV_SLICE_CLI_BOUNDARIES = 3


def _mesh_model(c: dict, seed: int, mesh=None):
    """ALBERT-large of the mesh phase (remat fused_ln, flash, or the ring
    on a seq axis; with ``fp32``: fp32, dense attention, no remat), seed
    weights cut to this rank's blocks on a mesh."""
    from dedloc_tpu_torch.models.albert import AlbertConfig, AlbertForPreTraining, init_weights
    from dedloc_tpu_torch.parallel.sharding import rules_for, shard_module

    on = lambda a: mesh if mesh is not None and a in mesh.shape else None
    over = dict(remat_policy="fused_ln", fused_ln=True,
                attention_impl="ring" if on("seq") else "flash")
    if c.get("fp32"):
        over = dict(dtype=torch.float32, attention_impl="dense", remat=False)
    if c.get("seq", MESH_SEQ) > 512:
        over["max_position_embeddings"] = c["seq"]
    if c.get("moe"):
        over["moe_experts"] = c["moe"]
    if mesh is not None:
        over.update(ring_mesh=on("seq"), pipe_mesh=on("pipe"),
                    moe_mesh=on("expert"), mesh=mesh)
    cfg = AlbertConfig.large(**over)
    model = AlbertForPreTraining(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    if mesh is not None and mesh.size > 1:
        shard_module(model, mesh, rules_for(mesh))
    return cfg, model.to(mesh.device if mesh is not None else "cuda")


def _flat_named(grads: dict, mesh=None, rules=()) -> tuple:
    """Gradients as one fp32 vector on the card in sorted JAX-name order
    (gathered to full tensors on a mesh; every rank calls): (names, each
    leaf's size, the vector)."""
    from dedloc_tpu_torch.models import convert
    from dedloc_tpu_torch.parallel.sharding import gather_tensor, port_spec, spec_for_path

    named = {}
    for n, g in grads.items():
        jname, perm = convert.grad_name(n, g.ndim)
        if mesh is not None:
            g = gather_tensor(g, port_spec(n, g.ndim, spec_for_path(jname, rules)), mesh)
        named[jname] = convert.to_jax_layout(g, perm).float().reshape(-1)
    names = sorted(named)
    return names, [named[k].numel() for k in names], torch.cat([named[k] for k in names])


def _worst_leaves(names, sizes, got, want, n=4) -> list:
    """The leaves that contribute most to ||got - want||: [name, share of
    the squared error, the leaf's own relative error]."""
    out, offset = [], 0
    total = float(torch.linalg.vector_norm(got - want)) ** 2
    for name, size in zip(names, sizes):
        d = got[offset:offset + size] - want[offset:offset + size]
        ref = float(torch.linalg.vector_norm(want[offset:offset + size]))
        err = float(torch.linalg.vector_norm(d))
        out.append([name[-48:], err ** 2 / max(total, 1e-30), err / max(ref, 1e-30)])
        offset += size
    return sorted(out, key=lambda t: -t[1])[:n]


def _mesh_steps(cfg, model, c, seed, mesh=None, steps=2):
    """``steps`` LAMB steps (accumulation 2) of ``model`` on the slice's
    batches; the first step's micro-batch metrics and mean gradients (flat,
    full) before its update, per-step launches, times and staged bytes."""
    from dedloc_tpu_torch.core.config import TrainingArguments
    from dedloc_tpu_torch.ops import flash_attention as fa
    from dedloc_tpu_torch.ops import fused_ln as fl
    from dedloc_tpu_torch.parallel import mesh as pm
    from dedloc_tpu_torch.parallel.sharding import rules_for
    from dedloc_tpu_torch.parallel.train_step import (
        TrainState, make_accumulate_step, make_guarded_apply_step, reduce_grads,
        zeros_like_grads)
    from dedloc_tpu_torch.roles.common import (
        build_loss_fn, build_optimizer, drop_collator_keys, loss_keys,
        synthetic_mlm_batches)
    from dedloc_tpu_torch.roles.trainer import _shard_state
    from dedloc_tpu_torch.utils.device import divide

    batch, seq = c.get("batch", MESH_BATCH), c.get("seq", MESH_SEQ)
    tx = build_optimizer(TrainingArguments(model_size="large", warmup_steps=0,
                                           per_device_batch_size=batch,
                                           seq_length=seq, seed=seed))
    params = dict(model.named_parameters())
    state = TrainState.create(params, tx)
    pspecs = ospecs = None
    if mesh is not None:
        state, pspecs, ospecs = _shard_state(state, mesh, tx, c.get("zero", False))
    accumulate = make_accumulate_step(build_loss_fn(model))
    apply = make_guarded_apply_step(tx, mesh=mesh, opt_state_sharding=ospecs,
                                    param_sharding=pspecs)
    batches = synthetic_mlm_batches(cfg, batch, seq, seed)
    wrappers = fa.WRAPPERS + fl.WRAPPERS
    device = mesh.device if mesh is not None else torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for w in wrappers:
        w.launches = 0
    out = dict(step_ms=[], launches_per_step=[], staged_bytes_per_step=[],
               losses=[], oks=[])
    for step in range(steps):
        before = {w.__name__: w.launches for w in wrappers}
        staged = pm.STAGING.bytes
        t0 = time.perf_counter()
        grad_acc, n = zeros_like_grads(params), 0
        for _ in range(2):
            host = next(batches)
            if mesh is None:
                b = drop_collator_keys(host, device=device)
            else:
                b = pm.put_batch({k: host[k] for k in loss_keys(host)}, mesh,
                                 seq_axis="seq" if "seq" in mesh.shape else None,
                                 seq_length=seq)
            grad_acc, n, metrics = accumulate(params, grad_acc, n, b)
            out["losses"].append({k: float(v) for k, v in metrics.items()})
        summed = (reduce_grads(grad_acc, mesh, pspecs) if mesh is not None
                  else grad_acc)
        mean = {k: divide(g, n) for k, g in summed.items()}
        if step == 0:
            torch.cuda.synchronize()
            pause = time.perf_counter()
            out["names"], out["sizes"], out["grads"] = _flat_named(
                mean, mesh, rules_for(mesh) if mesh is not None else ())
            t0 += time.perf_counter() - pause  # the check is not the step's
        state, ok = apply(state, mean)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["oks"].append(bool(ok))
        out["launches_per_step"].append({w.__name__: w.launches - before[w.__name__]
                                         for w in wrappers})
        out["staged_bytes_per_step"].append(pm.STAGING.bytes - staged)
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    out["state"], out["pspecs"], out["ospecs"] = state, pspecs, ospecs
    return out


def _mesh_digests(state, pspecs, ospecs) -> dict:
    """sha256 of each parameter and moment block this rank holds, with the
    mesh axes the block is split over."""
    digest = lambda t: hashlib.sha256(
        t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()).hexdigest()
    axes = lambda spec: [a for a in (spec or ()) if a is not None]
    out = {n: (digest(p), axes((pspecs or {}).get(n))) for n, p in state.params.items()}
    mspecs = ospecs.mu if ospecs is not None else (pspecs or {})
    for field in ("mu", "nu"):
        for n, t in getattr(state.opt_state, field).items():
            out[f"{field}:{n}"] = (digest(t), axes(mspecs.get(n)))
    return out


SWAV_SLICE_STEPS = 2  # the queue off, then on
# the fp32 slice step against the fp32 one-rank step, TF32 off (the JAX
# package's limits for its 8-device step, tests/test_swav.py): the loss
# before the first update within 1e-4, the new running statistics within
# 1e-5 (of each one's max |ref|), the whole gradient within 1e-3 relative
# or, where the step itself is less stable than that, within 1.5x its
# reordering floor: the distance between two one-rank steps on the same
# images in another order, measured in the same run. At full width and
# init the sinkhorn turns summation-order noise into a gradient 2.2e-2 away
# (PERF.md, section 6): the slice's sums are such a reordering. The bf16 cell
# is held to its own reordering floor the same way, and reports its
# distance beside the bf16-vs-fp32 floor.
SWAV_SLICE_LOSS_ATOL = 1e-4
SWAV_SLICE_GRAD_RTOL = 1e-3
SWAV_SLICE_STATS_RTOL = 1e-5
SWAV_SLICE_FLOOR_SHARE = 1.5


def _swav_slice_run(fp32: bool, seed: int, mesh=None, order=None) -> dict:
    """SWAV_SLICE_STEPS LARS steps of the full-width SwAV (queue 3,840, on
    the second step) on SWAV_BATCH global images: the slice's when ``mesh``
    is given, else one rank's. Each step is one micro-batch through the
    accumulate step, the ranks' gradient parts summed (``reduce_grads``, as
    ``Slice.full_grads``), and the guarded apply with the prototype
    post_apply (the slice's ``mesh_update``). The first step's loss,
    gradient (flat, sorted JAX names) and running statistics; per step ms,
    staged bytes, launches, and digests of params, statistics and queue."""
    import numpy as np

    from dedloc_tpu_torch.data.multicrop import MultiCropSpec, synthetic_multicrop_batches
    from dedloc_tpu_torch.models import convert
    from dedloc_tpu_torch.models.resnet import ResNetConfig
    from dedloc_tpu_torch.models.swav import (
        SwAVConfig, SwAVQueue, crop_tensors, init_swav, make_prototype_post_apply,
        make_swav_accumulate_step,
    )
    from dedloc_tpu_torch.optim.lars import Lars
    from dedloc_tpu_torch.optim.schedules import linear_warmup_cosine_annealing
    from dedloc_tpu_torch.parallel import mesh as pm
    from dedloc_tpu_torch.parallel.train_step import (
        TrainState, make_guarded_apply_step, reduce_grads, zeros_like_grads,
    )

    trunk = ResNetConfig(dtype=torch.float32) if fp32 else ResNetConfig()
    cfg = SwAVConfig(trunk=trunk, queue_length=SWAV_QUEUE)
    device = mesh.device if mesh is not None else torch.device("cuda")
    model, params, stats = init_swav(cfg, seed, device, mesh)
    queue = SwAVQueue.create(cfg, torch.Generator().manual_seed(seed + 1), device)
    tx = Lars(linear_warmup_cosine_annealing(0.6, 2, 100), momentum=0.9,
              weight_decay=1e-6)
    state = TrainState.create(params, tx)
    accumulate = make_swav_accumulate_step(model, cfg, mesh)
    apply = make_guarded_apply_step(tx, mesh=mesh, post_apply=make_prototype_post_apply())
    batches = synthetic_multicrop_batches(MultiCropSpec(), SWAV_BATCH, seed=seed)
    digest = lambda ts: hashlib.sha256(b"".join(
        t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()
        for t in ts)).hexdigest()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    out = dict(step_ms=[], staged_bytes_per_step=[], launches_per_step=[], losses=[],
               oks=[], digests=[])
    for step in range(SWAV_SLICE_STEPS):
        crops = next(batches)
        if order is not None:  # the same images in another order
            crops = [c.reshape(-1, SWAV_BATCH, *c.shape[1:])[:, order].reshape(c.shape)
                     for c in crops]
        before, staged = _port_launches(), pm.STAGING.bytes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, n, stats, queue, metrics = accumulate(
            state.params, stats, queue, zeros_like_grads(state.params), 0,
            crop_tensors(crops, device, SWAV_BATCH, mesh), 0, step > 0)
        summed = reduce_grads(grads, mesh) if mesh is not None else grads
        if step == 0:
            torch.cuda.synchronize()
            pause = time.perf_counter()
            named = convert.params_to_jax(summed)
            out["names"] = sorted(named)
            out["grads"] = np.concatenate([named[k].ravel() for k in out["names"]])
            out["stats"] = convert.params_to_jax(stats)
            t0 += time.perf_counter() - pause  # the check is not the step's
        state, ok = apply(state, summed)
        out["losses"].append(float(metrics["loss"]))  # waits for the step
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["oks"].append(bool(ok))
        after = _port_launches()
        out["launches_per_step"].append({k: after[k] - before[k] for k in after})
        out["staged_bytes_per_step"].append(pm.STAGING.bytes - staged)
        out["digests"].append(dict(
            params=digest(state.params.values()), stats=digest(stats.values()),
            queue=digest([queue.embeddings])))
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    out["params"] = sum(p.numel() for p in state.params.values())
    return out


def swav_slice_cell(name: str, seed: int, world: int, rank: int, refs: dict,
                    errors: list):
    """One SwAV slice cell of the mesh phase (``swav_dp2_fp32`` or
    ``swav_dp2``) on ``world`` ranks of this card, against the one-rank
    steps rank 0 runs first (fp32 always: the bf16 cell's floor); rank 0
    returns the cell's results."""
    import numpy as np
    import torch.distributed as dist

    from dedloc_tpu_torch.parallel import mesh as pm

    fp32 = name.endswith("fp32")
    order = np.random.default_rng(seed).permutation(SWAV_BATCH)
    for kind in ("fp32", "fp32 reordered") if fp32 else ("fp32", "bf16", "bf16 reordered"):
        if rank == 0 and kind not in refs:
            refs[kind] = _swav_slice_run(kind.startswith("fp32"), seed,
                                         order=order if "reordered" in kind else None)
            gc.collect()
            torch.cuda.empty_cache()
    dist.barrier()
    mesh = pm.make_mesh(world, ("data",), device_type="cuda")
    run = _swav_slice_run(fp32, seed, mesh)
    every = [None] * world
    dist.all_gather_object(every, dict(digests=run["digests"], peak=run["peak_bytes"],
                                       staged=run["staged_bytes_per_step"],
                                       launches=run["launches_per_step"],
                                       losses=run["losses"]))
    if rank != 0:
        return None
    kind = "fp32" if fp32 else "bf16"
    ref = refs[kind]
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    loss_err = abs(run["losses"][0] - ref["losses"][0])
    grad_err = rel(run["grads"], ref["grads"])
    floor = rel(refs[kind + " reordered"]["grads"], ref["grads"])
    grad_limit = max(SWAV_SLICE_GRAD_RTOL if fp32 else 0.0, SWAV_SLICE_FLOOR_SHARE * floor)
    stats_err = max(float(np.abs(run["stats"][k] - v).max() / np.abs(v).max())
                    for k, v in ref["stats"].items())
    out = dict(ranks=world, ranks_per_card=mesh.ranks_per_device, backend=mesh.backend,
               trunk="fp32" if fp32 else "bf16", params=run["params"],
               images_per_step=SWAV_BATCH, images_per_rank=SWAV_BATCH // world,
               queue=SWAV_QUEUE, step_ms=run["step_ms"], ms_per_step=run["step_ms"][-1],
               images_per_s=SWAV_BATCH / run["step_ms"][-1] * 1e3,
               staged_bytes_per_step=[e["staged"][-1] for e in every],
               peak_bytes_per_rank=[e["peak"] for e in every],
               launches_per_step_per_rank=[e["launches"][-1] for e in every],
               losses=run["losses"], one_rank_losses=ref["losses"],
               one_rank_ms_per_step=ref["step_ms"][-1],
               loss_abs_err=loss_err, grad_rel_err=grad_err, stats_rel_err=stats_err,
               reordered_one_rank_grad_rel_err=floor, grad_limit=grad_limit,
               reordered_one_rank_loss_abs_err=abs(
                   refs[kind + " reordered"]["losses"][0] - ref["losses"][0]))
    checks = [("gradient", grad_err, grad_limit)]
    if fp32:
        checks += [("loss", loss_err, SWAV_SLICE_LOSS_ATOL),
                   ("running statistics", stats_err, SWAV_SLICE_STATS_RTOL)]
    else:
        truth = refs["fp32"]["grads"]
        out.update(grad_rel_err_vs_fp32=rel(run["grads"], truth),
                   one_rank_grad_rel_err_vs_fp32=rel(ref["grads"], truth))
    for what, err, tol in checks:
        if not err <= tol:
            errors.append(f"{name}: {what} {err:.3e} from the one-rank step (> {tol:.3e})")
    if run["names"] != ref["names"]:
        errors.append(f"{name}: gradient names differ from the one-rank step")
    unequal = [f"{what} after step {step + 1}" for step in range(SWAV_SLICE_STEPS)
               for what in ("params", "stats", "queue")
               if len({e["digests"][step][what] for e in every}) != 1]
    if unequal:
        errors.append(f"{name}: the ranks' {unequal} differ")
    out["replicas_bitwise"] = not unequal
    if any(v for e in every for counts in e["launches"] for v in counts.values()):
        errors.append(f"{name}: the SwAV slice launched port kernels")
    if not all(run["oks"]) or not all(math.isfinite(x) for e in every for x in e["losses"]):
        errors.append(f"{name}: a non-finite loss or a rolled-back step")
    print(f"[mesh] {name}: {json.dumps({k: v for k, v in out.items() if k != 'losses'})}",
          file=sys.stderr, flush=True)
    return out


def mesh_worker(names: list, out_path: str, seed: int) -> int:
    """One rank of a torchrun launch of this script: each config of
    ``names`` (MESH_CONFIGS) as a slice of the launch's ranks on this card,
    against the one-rank step rank 0 runs first on the same weights and
    batches. Rank 0 writes the results (and every check's failure) to
    ``out_path``."""
    import torch.distributed as dist

    from dedloc_tpu_torch.parallel import mesh as pm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = int(os.environ["WORLD_SIZE"])
    pm.init_slice(world, "cuda")
    rank = dist.get_rank()
    refs, results, errors = {}, {}, []
    for name in names:
        if name.startswith("swav"):
            cell = swav_slice_cell(name, seed, world, rank, refs, errors)
            if rank == 0:
                results[name] = cell
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
            continue
        c = MESH_CONFIGS[name]
        key = (c.get("moe", 0), c.get("seq", MESH_SEQ), c.get("batch", MESH_BATCH))
        if rank == 0 and key not in refs:
            cfg, model = _mesh_model(c, seed)
            ref = _mesh_steps(cfg, model, c, seed, steps=1)
            refs[key] = dict(loss=ref["losses"][0], names=ref["names"],
                             sizes=ref["sizes"], grads=ref["grads"],
                             launches=ref["launches_per_step"][0],
                             step_ms=ref["step_ms"][0])
            del model, ref
            gc.collect()
            torch.cuda.empty_cache()
        if rank == 0 and "model" in c["axes"] and "truth" not in refs[key]:
            # the fp32 one-rank step (the exact gradient TP is held to)
            cfg, model = _mesh_model(dict(c, fp32=True), seed)
            refs[key]["truth"] = _mesh_steps(cfg, model, c, seed, steps=1)
            del model
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
        mesh = pm.make_mesh(world, c["axes"], c["shape"], device_type="cuda")
        cfg, model = _mesh_model(c, seed, mesh)
        # the fp32 check needs the gradient before the first update only
        run = _mesh_steps(cfg, model, c, seed, mesh, steps=1 if c.get("fp32") else 2)
        digests = _mesh_digests(run["state"], run["pspecs"], run["ospecs"])
        every = [None] * world
        dist.all_gather_object(every, dict(digests=digests, coords=mesh.index,
                                           launches=run["launches_per_step"],
                                           peak=run["peak_bytes"],
                                           staged=run["staged_bytes_per_step"]))
        del model
        if rank == 0:
            r = refs[key]
            expected = MESH_EXPECTED.get(name, MESH_EXPECTED["default"])
            loss, want = run["losses"][0]["mlm_loss"], r["loss"]["mlm_loss"]
            loss_err = abs(loss - want) / abs(want)
            if run["names"] != r["names"]:
                errors.append(f"{name}: gradient names differ from the one-rank step")
            diff = torch.linalg.vector_norm(run["grads"] - r["grads"])
            grad_err = float(diff / torch.linalg.vector_norm(r["grads"]))
            worst = _worst_leaves(r["names"], r["sizes"], run["grads"], r["grads"])
            if loss_err > MESH_LOSS_RTOL and not c.get("fp32"):
                errors.append(f"{name}: MLM loss {loss} vs one rank {want} "
                              f"(rel {loss_err:.3e} > {MESH_LOSS_RTOL})")
            truth = {}
            if "model" in c["axes"]:
                exact = r["truth"]["grads"]
                rel = lambda g: float(torch.linalg.vector_norm(g - exact)
                                      / torch.linalg.vector_norm(exact))
                truth = dict(grad_rel_err_vs_fp32=rel(run["grads"]),
                             one_rank_grad_rel_err_vs_fp32=rel(r["grads"]))
                if c.get("fp32"):
                    # the fp32 TP step against the fp32 one-rank step
                    grad_err = truth["grad_rel_err_vs_fp32"]
                    want = r["truth"]["losses"][0]["mlm_loss"]
                    loss_err = abs(loss - want) / abs(want)
                    if loss_err > MESH_LOSS_RTOL:
                        errors.append(f"{name}: MLM loss {loss} vs fp32 one rank "
                                      f"{want} (rel {loss_err:.3e})")
                    limit = MESH_FP32_GRAD_RTOL
                else:
                    limit = MESH_TP_NOISE_SHARE * truth["one_rank_grad_rel_err_vs_fp32"]
                if grad_err > limit:
                    errors.append(f"{name}: gradient rel err {grad_err:.3e} > "
                                  f"{limit:.3e} ({truth})")
            elif name != "ring" and grad_err > MESH_GRAD_RTOL:
                errors.append(f"{name}: gradient rel err {grad_err:.3e} > {MESH_GRAD_RTOL}")
            for rk, e in enumerate(every):
                for counts in e["launches"]:
                    if counts != expected:
                        errors.append(f"{name}: rank {rk} launched {counts} per "
                                      f"step (want {expected})")
            unequal = []
            for leaf, (_d, axes) in digests.items():
                groups = {}
                for e in every:
                    k = tuple(e["coords"][a] for a in axes)
                    groups.setdefault(k, set()).add(e["digests"][leaf][0])
                if any(len(v) > 1 for v in groups.values()):
                    unequal.append(leaf)
            if unequal:
                errors.append(f"{name}: replicated blocks differ across ranks: "
                              f"{unequal[:4]}")
            if not all(run["oks"]) or not all(
                    math.isfinite(m["loss"]) for m in run["losses"]):
                errors.append(f"{name}: non-finite loss or a rolled-back step")
            ms = run["step_ms"][-1]
            batch = c.get("batch", MESH_BATCH)
            results[name] = dict(
                axes=dict(zip(c["axes"], c["shape"])), ranks=world,
                ranks_per_card=mesh.ranks_per_device, backend=mesh.backend,
                zero=bool(c.get("zero")), seq_length=c.get("seq", MESH_SEQ),
                micro_batch=batch, moe_experts=c.get("moe", 0),
                ms_per_step=ms, step_ms=run["step_ms"],
                samples_per_s=2 * batch / (ms / 1e3),
                peak_bytes_per_rank=[e["peak"] for e in every],
                staged_bytes_per_step=[e["staged"][-1] for e in every],
                mlm_loss=loss, one_rank_mlm_loss=want, loss_rel_err=loss_err,
                grad_rel_err=grad_err, worst_leaves=worst, **truth,
                one_rank_ms_per_step=r["step_ms"],
                one_rank_launches=r["launches"],
                launches_per_step_per_rank=[e["launches"][-1] for e in every],
                expected_launches=expected, replicated_bitwise=not unequal,
                losses=[m["loss"] for m in run["losses"]])
            print(f"[mesh] {name}: {json.dumps({k: v for k, v in results[name].items() if k != 'losses'})}",
                  file=sys.stderr, flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(dict(results=results, errors=errors), f)
    dist.destroy_process_group()
    return 0


def _torchrun(n: int, *args) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(n), *args]


def mesh_steps_on_card(seed: int, work: str) -> dict:
    """The mesh configs through torchrun: dp2, tp2, ZeRO, pp2, ep2 and the
    ring on 2 ranks, dp2 x tp2 on 4, all on this card."""
    here = os.path.abspath(__file__)
    out = {}
    for n, names in ((2, ["dp2", "tp2", "tp2_fp32", "zero", "pp2", "ep2", "ring",
                          "swav_dp2_fp32", "swav_dp2"]),
                     (4, ["dp2tp2"])):
        path = os.path.join(work, f"mesh{n}.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            _torchrun(n, here, "--mesh-worker", ",".join(names),
                      "--mesh-out", path, "--seed", str(seed)),
            cwd=os.path.dirname(here), capture_output=True, text=True,
            timeout=600)
        for line in proc.stderr.splitlines():
            if line.startswith("[mesh]"):
                log(line)
        if proc.returncode != 0 or not os.path.exists(path):
            fail(f"mesh: the {n}-rank launch failed ({proc.returncode}):\n"
                 f"{proc.stderr[-4000:]}")
        with open(path) as f:
            got = json.load(f)
        if got["errors"]:
            fail("mesh: " + "; ".join(got["errors"]))
        out.update(got["results"])
        log(f"  {n}-rank launch: {time.perf_counter() - t0:.1f} s")
    return out


def two_slices(seed: int, work: str, tag: str, slice_flags: list, steps: int,
               target: int = 48, extra: tuple = ()) -> dict:
    """Two slices (torchrun, 2 ranks each) as two peers of one
    collaboration through the trainer CLI on this card (ALBERT-large, 6
    rows a rank, accumulation 2, 24 samples a boundary, fp16 wire), each
    rank 0 with
    its telemetry event log; stopped once both took ``steps`` averaged
    steps. Checks each slice's samples, backend, launches per boundary and
    the states' hashes at every common checkpointed step."""
    ports = {"A": _free_port(), "B": _free_port()}
    flags = ["-m", "dedloc_tpu_torch.roles.trainer",
             "--dht.experiment_prefix", f"chip-smoke-{tag}",
             "--dht.listen_host", "127.0.0.1",
             "--training.model_size", "large", "--training.remat_policy", "fused_ln",
             "--training.attention_impl", "flash",
             "--training.per_device_batch_size", "6", "--training.seq_length", "512",
             "--training.gradient_accumulation_steps", "2",
             *slice_flags,
             "--training.warmup_steps", "0", "--training.seed", str(seed),
             "--training.max_local_steps", "200", "--training.save_steps", "1",
             "--training.save_total_limit", "0",
             "--optimizer.target_batch_size", str(target),
             "--averager.compression", "float16",
             "--averager.min_refresh_period", "0.2",
             "--averager.default_refresh_period", "0.5",
             "--telemetry.enabled", "true", *extra]
    procs, logs = {}, {}
    t0 = time.perf_counter()
    try:
        for peer, other in (("A", "B"), ("B", "A")):
            pdir = os.path.join(work, tag, peer)
            os.makedirs(pdir)
            logs[peer] = open(os.path.join(pdir, "log.txt"), "w")
            procs[peer] = subprocess.Popen(
                _torchrun(2, *flags,
                          "--dht.listen_port", str(ports[peer]),
                          "--dht.initial_peers", f"127.0.0.1:{ports[other]}",
                          "--training.output_dir", pdir,
                          "--telemetry.event_log_path", os.path.join(pdir, "events.jsonl"),
                          "--training.train_log_path",
                          os.path.join(pdir, "train.jsonl")),
                stdout=logs[peer], stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__)),
                start_new_session=True)
        deadline = time.time() + MESH_CLI_DEADLINE_S
        while time.time() < deadline:
            done = all(sum(r["group_size"] == 2 for r in
                           _jsonl(os.path.join(work, tag, p, "train.jsonl")))
                       >= steps for p in procs)
            if done or any(pr.poll() is not None for pr in procs.values()):
                break
            time.sleep(1.0)
        for peer, pr in procs.items():
            if pr.poll() is not None:
                with open(os.path.join(work, tag, peer, "log.txt")) as f:
                    fail(f"{tag}: slice {peer} exited early ({pr.returncode}):\n"
                         f"{f.read()[-3000:]}")
    finally:
        for pr in procs.values():
            if pr.poll() is None:
                os.killpg(pr.pid, signal.SIGINT)
        for pr in procs.values():
            try:
                pr.wait(timeout=60)
            except subprocess.TimeoutExpired:
                os.killpg(pr.pid, signal.SIGKILL)
                pr.wait()
        for f in logs.values():
            f.close()
    wall_s = time.perf_counter() - t0
    reports = {}
    for peer in procs:
        pdir = os.path.join(work, tag, peer)
        records = _jsonl(os.path.join(pdir, "train.jsonl"))
        with open(os.path.join(pdir, "log.txt")) as f:
            text = f.read()
        joint = [r for r in records if r["group_size"] == 2]
        if len(joint) < steps:
            fail(f"{tag}: slice {peer} took {len(joint)} averaged steps "
                 f"(want {steps}):\n{text[-3000:]}")
        if any(r["samples"] != 6 * 2 * 2 for r in records):
            fail(f"{tag}: slice {peer} samples per boundary "
                 f"{sorted({r['samples'] for r in records})} != 24")
        if "backend gloo" not in text:
            fail(f"{tag}: slice {peer} did not log its gloo backend")
        prev = {"boundaries": 0, "kernel_launches": {k: 0 for k in COLLAB_EXPECTED}}
        for r in records:
            nb = r["boundaries"] - prev["boundaries"]
            got = {k: r["kernel_launches"][k] - prev["kernel_launches"][k]
                   for k in COLLAB_EXPECTED}
            if got != {k: v * nb for k, v in COLLAB_EXPECTED.items()}:
                fail(f"{tag}: slice {peer} rank 0 launched {got} in {nb} "
                     f"boundaries (want {COLLAB_EXPECTED} each)")
            prev = r
        reports[peer] = dict(
            averaged_steps=[r["step"] for r in joint],
            solo_steps=[r["step"] for r in records if r["group_size"] == 1],
            losses=[r["loss"] for r in records],
            samples_per_boundary=records[-1]["samples"],
            samples_per_s=statistics.mean(r["samples_per_second"] for r in joint),
            boundary_ms=statistics.median(r["boundary_ms"] for r in joint),
            boundaries=records[-1]["boundaries"],
            kernel_launches=records[-1]["kernel_launches"],
            max_memory_allocated=records[-1].get("max_memory_allocated"),
            events=_jsonl(os.path.join(pdir, "events.jsonl")), text=text)
    common = sorted(set(reports["A"]["averaged_steps"])
                    & set(reports["B"]["averaged_steps"]))
    hashes = {}
    for step in common:
        paths = [os.path.join(work, tag, p, f"checkpoint-{step}") for p in procs]
        if all(os.path.isdir(x) for x in paths):
            hashes[step] = [_state_hash(x) for x in paths]
    if not hashes or any(h[0] != h[1] for h in hashes.values()):
        fail(f"{tag}: the slices' states differ (or none common): "
             f"{ {s: h[0] == h[1] for s, h in hashes.items()} }")
    log(f"  states equal at every common averaged step {sorted(hashes)}")
    return dict(wall_s=wall_s, slices=reports, common_steps=sorted(hashes),
                states_equal_every_round=True, state_sha256=hashes[max(hashes)][0],
                checkpoint=os.path.join(work, tag, "A", f"checkpoint-{max(hashes)}"))


def _report(run: dict) -> dict:
    """``two_slices``' result without the logs and events it read."""
    out = dict(run)
    out["slices"] = {p: {k: v for k, v in r.items() if k not in ("events", "text")}
                     for p, r in run["slices"].items()}
    return out


def mesh_cli(seed: int, work: str) -> dict:
    """Two tp2 slices (dp1 x tp2) as two peers through the trainer CLI;
    their checkpoint is a one-device peer's (names, shapes, loads)."""
    from dedloc_tpu_torch.models import convert
    from dedloc_tpu_torch.roles.common import build_model, build_optimizer
    from dedloc_tpu_torch.core.config import TrainingArguments
    from dedloc_tpu_torch.parallel.train_step import TrainState
    from dedloc_tpu_torch.utils.checkpoint import load_checkpoint

    run = two_slices(seed, work, "mesh", ["--training.mesh_devices", "2",
                                          "--training.mesh_model_devices", "2"],
                     MESH_CLI_STEPS)
    named, _meta = load_checkpoint(run["checkpoint"])
    _cfg, model = build_model("large", device="cpu", seed=seed)
    tx = build_optimizer(TrainingArguments(model_size="large", warmup_steps=0))
    schema = {k: tuple(v.shape) for k, v in tx.state_views(
        dict(model.named_parameters()),
        TrainState.create(dict(model.named_parameters()), tx).opt_state).items()}
    if {k: tuple(v.shape) for k, v in named.items()} != schema:
        fail("mesh: the slice's checkpoint names/shapes differ from a one-device peer's")
    model.load_state_dict(convert.params_from_checkpoint(named))
    log(f"  {os.path.basename(run['checkpoint'])} loads into the one-device model")
    return dict(_report(run), checkpoint_schema_one_device=True)


def overlap_slices_cli(seed: int, work: str) -> dict:
    """Two dp2 ALBERT slices as two peers with
    ``--optimizer.overlap_averaging``: every round averages in the
    background while the ranks accumulate, and lands one boundary late. At
    least one late apply per peer (its telemetry's ``opt.overlap_applied``)
    and the overlap ledger's hidden and exposed seconds."""
    run = two_slices(seed, work, "overlap", ["--training.mesh_devices", "2"],
                     OVERLAP_CLI_STEPS, OVERLAP_CLI_TARGET,
                     ("--optimizer.overlap_averaging", "true"))
    for peer, rep in run["slices"].items():
        events = rep["events"]
        applied = [e for e in events if e.get("event") == "opt.overlap_applied"]
        ledger = [e for e in events if e.get("event") == "opt.overlap_ledger"]
        if not applied:
            fail(f"overlap: slice {peer} applied no round late:\n{rep['text'][-3000:]}")
        rep.update(late_applies=len(applied),
                   launched=sum(e.get("event") == "opt.overlap_launched" for e in events),
                   failed=sum(e.get("event") == "opt.overlap_failed" for e in events),
                   hidden_s=sum(e.get("hidden_s", 0.0) for e in ledger),
                   exposed_s=sum(e.get("exposed_s", 0.0) for e in ledger),
                   ledger=[{k: e.get(k) for k in ("round_id", "mode", "hidden_s",
                                                  "exposed_s", "efficiency")}
                           for e in ledger])
        log(f"  overlap slice {peer}: {rep['late_applies']} late applies, hidden "
            f"{rep['hidden_s']:.3f} s, exposed {rep['exposed_s']:.3f} s")
    return _report(run)


def swav_slice_cli(seed: int, work: str) -> dict:
    """The SwAV peer as a dp2 slice through ``python -m
    dedloc_tpu_torch.roles.swav --training.mesh_devices 2`` under torchrun
    at full width (16 images a rank, queue 3,840 from global step 1), a
    solo peer for SWAV_SLICE_CLI_BOUNDARIES boundaries; its checkpoint
    loads into a one-device port peer (names, shapes)."""
    from dedloc_tpu_torch.models.swav import SwAVConfig, init_swav
    from dedloc_tpu_torch.roles.swav import checkpoint_tree, restore_checkpoint
    from dedloc_tpu_torch.utils.checkpoint import load_latest_checkpoint

    out_dir = os.path.join(work, "swav_slice")
    cmd = _torchrun(2, "-m", "dedloc_tpu_torch.roles.swav",
                    "--dht.experiment_prefix", "chip-smoke-swav-slice",
                    "--dht.listen_host", "127.0.0.1",
                    "--dht.listen_port", str(_free_port()),
                    "--training.mesh_devices", "2",
                    "--training.per_device_batch_size", str(SWAV_BATCH // 2),
                    "--training.max_local_steps", str(SWAV_SLICE_CLI_BOUNDARIES),
                    "--training.queue_length", str(SWAV_QUEUE),
                    "--training.queue_start_step", "1",
                    "--training.seed", str(seed),
                    "--training.save_steps", "1", "--training.save_total_limit", "1",
                    "--training.output_dir", out_dir,
                    "--optimizer.target_batch_size", str(SWAV_BATCH),
                    "--checkpoint.cache_dir", "none",
                    "--averager.averaging_expiration", "0.5",
                    "--averager.min_refresh_period", "0.2",
                    "--averager.default_refresh_period", "0.5",
                    "--averager.metadata_expiration", "300")
    t0 = time.perf_counter()
    with open(os.path.join(work, "swav_slice.log"), "w") as logf:
        proc = subprocess.run(cmd, stdout=logf, stderr=subprocess.STDOUT,
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              timeout=420, start_new_session=True)
    wall_s = time.perf_counter() - t0
    with open(os.path.join(work, "swav_slice.log")) as f:
        text = f.read()
    if proc.returncode:
        fail(f"swav_slice: the slice exited {proc.returncode}:\n{text[-3000:]}")
    if "swav slice mesh: {'data': 2}" not in text or "backend gloo" not in text:
        fail(f"swav_slice: no dp2 gloo slice in the log:\n{text[-3000:]}")
    applied = re.findall(r"global step (\d+): loss ([-\d.naif]+) \(apply (\w+), group (\d+)\)",
                         text)
    losses = [float(a[1]) for a in applied]
    if not applied or any(a[2] != "leaf" for a in applied) or not all(
            math.isfinite(x) for x in losses):
        fail(f"swav_slice: global steps {applied} (want at least one, finite, "
             f"through the slice's per-leaf apply):\n{text[-3000:]}")
    if "queue engaged" not in text and int(applied[-1][0]) > 1:
        fail(f"swav_slice: the queue never engaged:\n{text[-3000:]}")
    step, tree, _meta = load_latest_checkpoint(out_dir)
    model, params, stats = init_swav(SwAVConfig(), seed + 7, "cuda")
    want = {k: v.shape for k, v in checkpoint_tree(params, stats).items()}
    if {k: tuple(v.shape) for k, v in tree.items()} != want:
        fail("swav_slice: the slice's checkpoint names/shapes differ from a "
             "one-device peer's")
    stats = restore_checkpoint(tree, params, stats)
    if not all(torch.isfinite(t).all() for t in list(stats.values()) + list(params.values())):
        fail("swav_slice: non-finite state in the slice's checkpoint")
    out = dict(wall_s=wall_s, boundaries=SWAV_SLICE_CLI_BOUNDARIES,
               global_steps=[int(a[0]) for a in applied], losses=losses,
               checkpoint_step=step, checkpoint_loads_one_device=True,
               queue_engaged="queue engaged" in text)
    log(f"  swav slice peer: {json.dumps(out)}")
    del model, params, stats
    return out


def phase_mesh(seed: int) -> dict:
    """The ALBERT slice on a torch.distributed mesh of ranks sharing this
    card: each axis against the one-rank step, and two CLI slices as peers."""
    from dedloc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="mesh-", dir=_build.BUILD_DIR)
    try:
        log("[mesh] dp2, tp2, ZeRO-1, pp2, ep2, ring (2 ranks), dp2 x tp2 (4 ranks)")
        runs = mesh_steps_on_card(seed, work)
        log("[mesh] two torchrun slices (tp2) as peers through the trainer CLI")
        cli = mesh_cli(seed, work)
        log("[mesh] the SwAV peer as a dp2 slice through its CLI")
        swav_slice = swav_slice_cli(seed, work)
        log("[mesh] two dp2 slices as peers with overlap averaging")
        overlap = overlap_slices_cli(seed, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(runs=runs, cli=cli, swav_slice=swav_slice, overlap_slices=overlap,
                phase_s=time.perf_counter() - t0)


# ---------------------------------------------------------------- phase 12

TOOLS_PIECES_EXPECTED = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                         "ln_fwd", "ln_bwd")


def phase_tools(seed: int) -> dict:
    """The port's tensor tools on the card: ``graft_entry.dryrun_multichip``
    over 4 ranks sharing this card (the step, ZeRO, pipeline, experts, the
    role-MoE slice and two collaborative slices), then ``profile_albert``
    ``peak`` and ``pieces`` at [12, 512, 16, 64], the launch counters reset
    just before the pieces and read just after."""
    import numpy as np

    from dedloc_tpu_torch import graft_entry
    from dedloc_tpu_torch.ops import flash_attention as fa
    from dedloc_tpu_torch.ops import fused_ln as fl
    from dedloc_tpu_torch.tools import profile_albert as pa

    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(4)
    dry_s = time.perf_counter() - t0
    if not np.isfinite(dry["loss"]) or dry["counts"] != [(1, 2)] * 4:
        fail(f"tools: dryrun loss {dry['loss']}, (step, ZeRO step) per rank "
             f"{dry['counts']} (want finite and (1, 2) on each of 4 ranks)")
    slices = dry["collaborative_slices"]
    log(f"[tools] dryrun_multichip(4) on {dry['mesh']}: loss {dry['loss']:.6f}, "
        f"ZeRO step {dry['zero_step']}, pipeline {dry['pipeline_loss']:.6f}, "
        f"MoE {dry['moe_loss']:.6f}, role-MoE step {dry['role_moe']['step']}, "
        f"slice groups {slices} ({dry_s:.1f} s)")
    for w in fa.WRAPPERS + fl.WRAPPERS:
        w.launches = 0
    t1 = time.perf_counter()
    prof = pa.Profiler(torch.device("cuda"))
    peak = pa.run_peak(prof)
    pa.run_pieces(prof)
    launches = {w.__name__: w.launches for w in fa.WRAPPERS + fl.WRAPPERS}
    pieces_s = time.perf_counter() - t1
    missing = [n for n in TOOLS_PIECES_EXPECTED if not launches.get(n)]
    if missing:
        fail(f"tools: profile pieces launched no {missing} ({launches})")
    log(f"[tools] profile pieces: {len(prof.rows)} rows, launches {launches} "
        f"({pieces_s:.1f} s)")
    return dict(dryrun=dict(mesh=dry["mesh"], loss=dry["loss"],
                            metrics=dry["metrics"], zero_step=dry["zero_step"],
                            counts=dry["counts"], pipeline_loss=dry["pipeline_loss"],
                            moe_loss=dry["moe_loss"], role_moe=dry["role_moe"],
                            collaborative_slices=slices, wall_s=dry_s),
                profile=dict(achievable_peak_tflops=peak, rows=prof.rows,
                             launches=launches, wall_s=pieces_s),
                phase_s=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # internal: one rank of the mesh phase's torchrun launches
    ap.add_argument("--mesh-worker", default="")
    ap.add_argument("--mesh-out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import dedloc_tpu_torch  # noqa: F401  (fails outside a checkout)

    if args.mesh_worker:
        return mesh_worker(args.mesh_worker.split(","), args.mesh_out, args.seed)

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
    mesh = phase_mesh(args.seed)
    tools = phase_tools(args.seed)

    rows = []
    for k in kernels:
        name = k.pop("name")
        max_abs_err, samples_with_keys = k.pop("err")
        # launches: the count from the run of the path the row was measured at
        run = k.pop("launch_counts", None) or {
            f"S={LONG_SEQ}": longctx, "SwAV": swav["local"]}.get(k["path"], path)
        kernel = k.pop("kernel", None)
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
            # the mesh cells: launches per optimizer step of each rank
            rows[-1]["launches_mesh_per_rank_per_step"] = {
                cell: [counts[name] for counts in run["launches_per_step_per_rank"]]
                for cell, run in mesh["runs"].items()}
            # the two overlapping dp2 slices: rank 0's launches, and per boundary
            # the tools phase's profile pieces (graph warm-up and capture
            # calls; replays launch through the graph, not the wrapper)
            rows[-1]["launches_tools_pieces"] = tools["profile"]["launches"][name]
            rows[-1]["launches_overlap_slices"] = {
                peer: dict(total=rep["kernel_launches"][name],
                           per_boundary=rep["kernel_launches"][name] / rep["boundaries"])
                for peer, rep in mesh["overlap_slices"]["slices"].items()}
        if rows[-1]["route"] == "cuda":
            # ptxas at the path's head dim: the registers a thread is launched
            # with (the backward's consumer warpgroups raise theirs with
            # setmaxnreg), and the tensor-core rate this call reached
            rows[-1].update(build_regs[kernel or f"{name}_kernel<{k['shape'][3]}>"])
            rows[-1]["tflops"] = k["tensor_flops"] / (rows[-1]["ms"] * 1e-3) / 1e12
    print(json.dumps({"build": {"nvcc_seconds": build_s, "ptxas": build_regs}}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"path": path}))
    print(json.dumps({"longctx": longctx}))
    print(json.dumps({"collab": collab}))
    print(json.dumps({"downstream": downstream}))
    print(json.dumps({"swav": swav}))
    print(json.dumps({"moe": moe}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"tools": tools}))
    print(json.dumps({"script_s": time.perf_counter() - script_t0}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
