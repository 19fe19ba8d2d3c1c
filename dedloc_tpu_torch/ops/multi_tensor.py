"""Multi-tensor passes of the boundary's optimizer step: hand-written Triton
kernels on the card, their plain PyTorch versions on the CPU.

At a global-batch boundary a peer off a mesh takes the accumulator's mean
(with the contribution clip) and one LAMB or LARS step over every leaf of
its model, then keeps the step only if the new parameters are all finite
(``parallel/train_step.py`` ``make_flat_apply_step``). These passes run
that step over the port's own per-leaf tensors (parameters, gradients,
moments or momentum) in place. A ``LeafTable`` lists the leaves of one
layout in order, with each leaf's size and flag (LAMB: weight decay; LARS:
excluded from the trust ratio), and cuts every leaf into ``CHUNK``-element
chunks; a program of a pass takes one chunk of one leaf, so one grid covers
leaves from one element to the largest expert matrix, and the launches do
not depend on the number of leaves. Each call binds its tensors to the
table (``LeafTable.bind``): their addresses, as element offsets from one of
them, go to the device in one asynchronous copy from pinned memory (no
host synchronisation; the pinned block is not reused before the copy has
run). Nothing is flattened and no temporary of a parameter's size is made
beyond the outputs a pass names.

Kernels (Triton, built at first launch):

- ``_sq_kernel`` (``sumsq``, ``all_finite``): one partial a chunk: the sum
  of squares of a role (of ``x / divisor`` for the accumulator's mean), or
  the count of its non-finite elements.
- ``_leaf_sums_kernel``: each leaf's chunk partials summed in chunk order,
  one program a leaf (and a row of partials): a fixed-order sum, the same
  bits on every run, no atomics.
- ``_copy_kernel`` (``scaled_copy``): ``dst = src / divisor`` (an IEEE
  division, as ``utils/device.py`` ``divide``), times the clip's scale.
- ``_lamb_kernel`` (``lamb_norms``, ``lamb_candidate``, ``lamb_commit``):
  the clip by the global norm, the moments, the bias-corrected Adam
  direction with weight decay; then the chunk partials of ``Σw²`` and
  ``Σu²``, or the candidate parameters ``w + (-lr) · (u · ratio)``, or the
  commit, which reads the guard's verdict on the device and, where it
  holds, writes the moments again and copies the kept parameters in.
- ``_lars_kernel`` (``lars_norms``, ``lars_candidate``, ``lars_commit``):
  ``g + wd · w``; the partials of ``Σw²`` and ``Σg²``, or the candidate
  ``w + (momentum · m + (-rate) · g)``, or the commit of the momentum and
  the kept parameters.

Each element sees the operations of the port's ``Lamb`` / ``Lars`` in their
order (``optim/lamb.py``, ``optim/lars.py``): divisions and square roots
are IEEE (``div_rn``, ``sqrt_rn``) and no multiply is fused into an add,
as PyTorch's eager kernels compute them; only the norms' summation order
differs. Per-leaf scalars (trust ratios, local rates) are computed by
PyTorch on ``[L]`` vectors between the passes.

They replace no TPU kernel: the JAX package leaves the update to XLA,
which fuses the flat step's elementwise chain. What bounds them on an H100
is memory bandwidth: one boundary with LAMB and its global clip moves 80
bytes a parameter, by pass: the mean 8 (read the accumulator, write the
gradient), the clip's norm 4, the norms 16 (gradient, parameter, both
moments), the candidate 20 (the same, and write it), the guard 4 (read
it), the commit 28 (read the four and the candidate, write the parameter
and both moments). A chunk that lies wholly inside its leaf loads 16 bytes
a thread at once wherever every bound tensor is 16-byte aligned.

Each wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. ``<wrapper>.launches`` counts
calls (one a call, whatever the kernels inside it).
"""
from __future__ import annotations

import functools
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dedloc_tpu_torch.ops import _build
from dedloc_tpu_torch.utils.device import divide, on_card

CHUNK = 4096  # elements a program takes: one chunk of one leaf (16 a thread)
_WARPS = 8
_SUM_BLOCK = 1024  # chunk partials a leaf-sum program adds at a time
ALIGN = 4  # elements: leaves of a buffer ``empty_like`` makes start 16-byte aligned

# role indices of the bound tensor lists: LAMB binds G, P, MU, NU, OUT;
# LARS binds gradients, parameters, momentum and out (0-3)
G, P, MU, NU, OUT = 0, 1, 2, 3, 4
_NORMS, _CANDIDATE, _COMMIT = 0, 1, 2
_SQ, _MEAN_SQ, _NONFINITE = 0, 1, 2


class LeafTable:
    """The leaves of one layout in order: each leaf's size, flag and chunk
    range. Leaf ``l`` owns chunks ``chunk0[l] .. chunk0[l + 1] - 1``;
    ``chunk_leaf[c]`` is the leaf of chunk ``c``, whose first element is
    ``(c - chunk0[leaf]) * CHUNK`` of that leaf. ``offsets`` place the
    leaves in one buffer (``empty_like``), each at a multiple of ``ALIGN``
    elements. The device copies are made once per device."""

    def __init__(self, sizes: Sequence[int], flags: Sequence[bool] = ()):
        self.sizes = np.asarray(list(sizes), np.int64).reshape(-1)
        if len(flags) and len(flags) != len(self.sizes):
            raise ValueError("one flag per leaf")
        self.flags = (np.asarray(list(flags), np.int32) if len(flags)
                      else np.zeros(len(self.sizes), np.int32))
        counts = -(-self.sizes // CHUNK)
        self.chunk0 = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        self.chunk_leaf = np.repeat(np.arange(len(self.sizes), dtype=np.int32), counts)
        self.n_chunks = int(self.chunk0[-1])
        padded = -(-self.sizes // ALIGN) * ALIGN
        self.offsets = np.concatenate([[0], np.cumsum(padded)]).astype(np.int64)
        self._on_device: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def __len__(self) -> int:
        return len(self.sizes)

    def arrays(self, device) -> Dict[str, torch.Tensor]:
        """The table on ``device``: ``chunk_leaf``, ``chunk0`` (int32),
        ``sizes`` (int64), ``flags`` (int32)."""
        device = torch.device(device)
        cached = self._on_device.get(device)
        if cached is None:
            cached = self._on_device[device] = {
                "chunk_leaf": torch.from_numpy(self.chunk_leaf).to(device),
                "chunk0": torch.from_numpy(self.chunk0).to(device),
                "sizes": torch.from_numpy(self.sizes).to(device),
                "flags": torch.from_numpy(self.flags).to(device),
            }
        return cached

    def empty_like(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """fp32 tensors shaped like ``tensors``, views of one new buffer."""
        flat = torch.empty(int(self.offsets[-1]), dtype=torch.float32,
                           device=tensors[0].device)
        return [flat[o:o + t.numel()].view(t.shape)
                for o, t in zip(self.offsets.tolist(), tensors)]

    def bind(self, roles: Sequence[Sequence[torch.Tensor]]) -> "Bound":
        """The passes' operands: ``roles[r][l]`` is leaf ``l`` of role ``r``
        (one list a role, in table order)."""
        return Bound(self, [list(r) for r in roles])


class Bound:
    """A table with the tensors of one call. On the card: each tensor's
    address as an element offset (in units of ``vec``) from ``base``, the
    first leaf of the first role, in ``offs [R, L]`` on the device."""

    def __init__(self, table: LeafTable, roles: List[List[torch.Tensor]],
                 rows: Optional[List[Optional[list]]] = None):
        self.table, self.roles = table, roles
        sizes = table.sizes.tolist()
        for r, role in enumerate(roles):
            if len(role) != len(sizes):
                raise ValueError(f"role {r}: {len(role)} tensors for {len(sizes)} leaves")
        first = roles[0][0]
        self.on_card = on_card(first, "multi-tensor pass")
        self.base = self.offs = None
        self.vec = 1
        if not self.on_card:
            return
        # each role's addresses; a role already checked by the binding it
        # came from (``rebind``) keeps its row
        rows = list(rows or [None] * len(roles))
        for r, role in enumerate(roles):
            if rows[r] is not None:
                continue
            for t, size in zip(role, sizes):
                if t.device != first.device or t.dtype != torch.float32:
                    raise ValueError(f"role {r}: every leaf fp32 on {first.device}, "
                                     f"got {t.dtype} on {t.device}")
                if t.numel() != size or not t.is_contiguous():
                    raise ValueError(f"role {r}: a contiguous leaf of {size} "
                                     f"elements, got {tuple(t.shape)} "
                                     f"strides {t.stride()}")
            rows[r] = [t.data_ptr() if t.numel() else None for t in role]
        self.rows = rows
        base = first.data_ptr()
        live = [a - base for row in rows for a in row if a is not None]
        self.vec = 4 if base % 16 == 0 and all(d % 16 == 0 for d in live) else 1
        unit = 4 * self.vec
        host = torch.tensor([[0 if a is None else (a - base) // unit for a in row]
                             for row in rows], dtype=torch.int64)
        self.base = first
        self.offs = host.pin_memory().to(first.device, non_blocking=True)

    def rebind(self, r: int, role: Sequence[torch.Tensor]) -> "Bound":
        """This binding with role ``r`` taken by ``role``: only its tensors
        are checked, and the offsets go to the device again."""
        role = list(role)
        if all(a is b for a, b in zip(role, self.roles[r])):
            return self
        roles = [role if i == r else x for i, x in enumerate(self.roles)]
        rows = (None if not self.on_card or r == 0
                else [None if i == r else x for i, x in enumerate(self.rows)])
        return Bound(self.table, roles, rows)

    def args(self):
        """The kernels' leading arguments."""
        a = self.table.arrays(self.base.device)
        return (self.base, self.offs, a["chunk_leaf"], a["chunk0"], a["sizes"],
                a["flags"], len(self.table))


# ------------------------------------------------------------ plain versions


def _dot(x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(-1)
    return torch.dot(x, x)


def sumsq_plain(xs, divisor=None) -> torch.Tensor:
    """``[L]``: each leaf's sum of squares (of ``x / divisor``)."""
    return torch.stack([_dot(x if divisor is None else divide(x, divisor)) for x in xs])


def all_finite_plain(xs) -> torch.Tensor:
    return torch.stack([torch.isfinite(x).all() for x in xs]).all()


def scaled_copy_plain(src, dst, divisor, scale=None) -> None:
    for s, d in zip(src, dst):
        x = divide(s, divisor)
        d.copy_(x if scale is None else x * scale)


def _lamb_moments(g, mu, nu, hp, g_norm):
    """(clipped g, new mu, new nu) of one leaf."""
    if hp.max_grad_norm is not None:
        g = torch.where(g_norm < hp.max_grad_norm, g, (g / g_norm) * hp.max_grad_norm)
    return g, mu * hp.b1 + (1 - hp.b1) * g, nu * hp.b2 + (1 - hp.b2) * g * g


def _lamb_direction(g, p, mu, nu, decay, hp, g_norm, bc1, bc2):
    """The leaf's Adam direction with weight decay, before the trust ratio."""
    _g, m, v = _lamb_moments(g, mu, nu, hp, g_norm)
    u = (m / bc1) / (torch.sqrt(v / bc2) + hp.eps)
    if hp.weight_decay > 0.0 and decay:
        u = u + hp.weight_decay * p
    return u


def lamb_norms_plain(b: Bound, hp, g_norm, bc1, bc2) -> torch.Tensor:
    g, p, mu, nu = b.roles[:4]
    rows = [[], []]
    for i in range(len(b.table)):
        u = _lamb_direction(g[i], p[i], mu[i], nu[i], b.table.flags[i], hp, g_norm,
                            bc1, bc2)
        rows[0].append(_dot(p[i]))
        rows[1].append(_dot(u))
    return torch.stack([torch.stack(r) for r in rows])


def lamb_candidate_plain(b: Bound, hp, g_norm, bc1, bc2, neg_lr, ratio) -> None:
    g, p, mu, nu, out = b.roles
    for i in range(len(b.table)):
        u = _lamb_direction(g[i], p[i], mu[i], nu[i], b.table.flags[i], hp, g_norm,
                            bc1, bc2)
        out[i].copy_(p[i] + neg_lr * (u * ratio[i]))


def lamb_commit_plain(b: Bound, hp, g_norm, ok) -> None:
    g, p, mu, nu, out = b.roles
    for i in range(len(b.table)):
        _g, m, v = _lamb_moments(g[i], mu[i], nu[i], hp, g_norm)
        mu[i].copy_(torch.where(ok, m, mu[i]))
        nu[i].copy_(torch.where(ok, v, nu[i]))
        p[i].copy_(torch.where(ok, out[i], p[i]))


def lars_norms_plain(b: Bound, weight_decay: float) -> torch.Tensor:
    g, p = b.roles[:2]
    return torch.stack([
        torch.stack([_dot(w) for w in p]),
        torch.stack([_dot(x + weight_decay * w) for x, w in zip(g, p)])])


def _lars_momentum(g, p, mom, hp, neg_rate):
    return hp.momentum * mom + neg_rate * (g + hp.weight_decay * p)


def lars_candidate_plain(b: Bound, hp, neg_rate) -> None:
    g, p, mom, out = b.roles
    for i in range(len(b.table)):
        out[i].copy_(p[i] + _lars_momentum(g[i], p[i], mom[i], hp, neg_rate[i]))


def lars_commit_plain(b: Bound, hp, neg_rate, ok) -> None:
    g, p, mom, out = b.roles
    for i in range(len(b.table)):
        m = _lars_momentum(g[i], p[i], mom[i], hp, neg_rate[i])
        mom[i].copy_(torch.where(ok, m, mom[i]))
        p[i].copy_(torch.where(ok, out[i], p[i]))


# ------------------------------------------------------------------ kernels

_KERNELS = None


def _kernels():
    """Define the Triton kernels on first use (the CPU test environment has
    no Triton, so nothing here runs at import)."""
    global _KERNELS
    if _KERNELS is not None:
        return _KERNELS
    os.environ.setdefault("TRITON_CACHE_DIR", str(_build.BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def _locate(CHUNK_LEAF, CHUNK0, SIZES, BLOCK: tl.constexpr):
        """(chunk, leaf, first element, elements left in the leaf from it)."""
        pid = tl.program_id(0)
        leaf = tl.load(CHUNK_LEAF + pid)
        start = (pid - tl.load(CHUNK0 + leaf)).to(tl.int64) * BLOCK
        return pid, leaf, start, tl.load(SIZES + leaf) - start

    @triton.jit
    def _at(BASE, OFFS, role: tl.constexpr, L, leaf, start, VEC: tl.constexpr):
        """The chunk's first element of ``role``: the offset times VEC keeps
        the 16-byte alignment visible to the compiler where VEC is 4."""
        return BASE + tl.load(OFFS + role * L + leaf) * VEC + start

    @triton.jit
    def _ld(ptr, idx, n, MASKED: tl.constexpr):
        if MASKED:
            x = tl.load(ptr + idx, mask=idx < n, other=0.0)
        else:
            x = tl.load(ptr + idx)
        return x

    @triton.jit
    def _st(ptr, idx, n, x, MASKED: tl.constexpr):
        if MASKED:
            tl.store(ptr + idx, x, mask=idx < n)
        else:
            tl.store(ptr + idx, x)

    @triton.jit
    def _sq_block(X, PART, pid, idx, n, divisor, MODE: tl.constexpr,
                  MASKED: tl.constexpr):
        x = _ld(X, idx, n, MASKED)
        if MODE == 2:  # non-finite count (|x| above fp32's largest); a masked lane reads 0
            r = tl.sum(tl.where(tl.abs(x) <= 3.4028234663852886e38, 0.0, 1.0), axis=0)
        else:
            if MODE == 1:
                x = tl.math.div_rn(x, divisor)
            r = tl.sum(x * x, axis=0)
        tl.store(PART + pid, r)

    @triton.jit
    def _sq_kernel(BASE, OFFS, CHUNK_LEAF, CHUNK0, SIZES, FLAGS, L, PART, divisor,
                   ROLE: tl.constexpr, MODE: tl.constexpr, VEC: tl.constexpr,
                   BLOCK: tl.constexpr):
        pid, leaf, start, n = _locate(CHUNK_LEAF, CHUNK0, SIZES, BLOCK)
        x = _at(BASE, OFFS, ROLE, L, leaf, start, VEC)
        idx = tl.arange(0, BLOCK)
        if n >= BLOCK:
            _sq_block(x, PART, pid, idx, n, divisor, MODE, False)
        else:
            _sq_block(x, PART, pid, idx, n, divisor, MODE, True)

    @triton.jit
    def _leaf_sums_kernel(PART, CHUNK0, OUT, C, L, BLOCK: tl.constexpr):
        leaf = tl.program_id(0)
        row = tl.program_id(1)
        c0 = tl.load(CHUNK0 + leaf)
        c1 = tl.load(CHUNK0 + leaf + 1)
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        for c in range(c0, c1, BLOCK):
            i = c + tl.arange(0, BLOCK)
            acc += tl.load(PART + row * C + i, mask=i < c1, other=0.0)
        tl.store(OUT + row * L + leaf, tl.sum(acc, axis=0))

    @triton.jit
    def _copy_block(SRC, DST, idx, n, divisor, scale, SCALED: tl.constexpr,
                    MASKED: tl.constexpr):
        x = tl.math.div_rn(_ld(SRC, idx, n, MASKED), divisor)
        if SCALED:
            x = x * scale
        _st(DST, idx, n, x, MASKED)

    @triton.jit
    def _copy_kernel(BASE, OFFS, CHUNK_LEAF, CHUNK0, SIZES, FLAGS, L, SCALE, divisor,
                     SCALED: tl.constexpr, VEC: tl.constexpr, BLOCK: tl.constexpr):
        pid, leaf, start, n = _locate(CHUNK_LEAF, CHUNK0, SIZES, BLOCK)
        src = _at(BASE, OFFS, 0, L, leaf, start, VEC)
        dst = _at(BASE, OFFS, 1, L, leaf, start, VEC)
        idx = tl.arange(0, BLOCK)
        if SCALED:
            scale = tl.load(SCALE)
        else:
            scale = 1.0
        if n >= BLOCK:
            _copy_block(src, dst, idx, n, divisor, scale, SCALED, False)
        else:
            _copy_block(src, dst, idx, n, divisor, scale, SCALED, True)

    @triton.jit
    def _lamb_block(G, W, MU, NU, O, PART, pid, C, idx, n, gnorm, bc1, bc2, neg_lr,
                    ratio, decay, b1, omb1, b2, omb2, eps, wd, mgn,
                    CLIP: tl.constexpr, HAS_WD: tl.constexpr, MODE: tl.constexpr,
                    MASKED: tl.constexpr):
        g = _ld(G, idx, n, MASKED)
        if CLIP:
            g = tl.where(gnorm < mgn, g, tl.math.div_rn(g, gnorm) * mgn)
        m = _ld(MU, idx, n, MASKED) * b1 + omb1 * g
        v = _ld(NU, idx, n, MASKED) * b2 + omb2 * g * g
        if MODE == 2:
            _st(MU, idx, n, m, MASKED)
            _st(NU, idx, n, v, MASKED)
            _st(W, idx, n, _ld(O, idx, n, MASKED), MASKED)
        else:
            w = _ld(W, idx, n, MASKED)
            u = tl.math.div_rn(tl.math.div_rn(m, bc1),
                               tl.math.sqrt_rn(tl.math.div_rn(v, bc2)) + eps)
            if HAS_WD:
                u = tl.where(decay != 0, u + wd * w, u)
            if MODE == 0:
                tl.store(PART + pid, tl.sum(w * w, axis=0))
                tl.store(PART + C + pid, tl.sum(u * u, axis=0))
            else:
                _st(O, idx, n, w + neg_lr * (u * ratio), MASKED)

    @triton.jit
    def _lamb_kernel(BASE, OFFS, CHUNK_LEAF, CHUNK0, SIZES, FLAGS, L, PART, C,
                     GNORM, BC1, BC2, NEG_LR, RATIO, OK,
                     b1, omb1, b2, omb2, eps, wd, mgn,
                     CLIP: tl.constexpr, HAS_WD: tl.constexpr, MODE: tl.constexpr,
                     VEC: tl.constexpr, BLOCK: tl.constexpr):
        if MODE == 2:
            go = tl.load(OK) != 0
        else:
            go = True
        if go:
            pid, leaf, start, n = _locate(CHUNK_LEAF, CHUNK0, SIZES, BLOCK)
            g = _at(BASE, OFFS, 0, L, leaf, start, VEC)
            w = _at(BASE, OFFS, 1, L, leaf, start, VEC)
            mu = _at(BASE, OFFS, 2, L, leaf, start, VEC)
            nu = _at(BASE, OFFS, 3, L, leaf, start, VEC)
            o = _at(BASE, OFFS, 4, L, leaf, start, VEC)
            if CLIP:
                gnorm = tl.load(GNORM)
            else:
                gnorm = 0.0
            if MODE == 2:
                bc1, bc2, neg_lr, ratio, decay = 1.0, 1.0, 0.0, 0.0, 0
            else:
                bc1 = tl.load(BC1)
                bc2 = tl.load(BC2)
                decay = tl.load(FLAGS + leaf)
                if MODE == 1:
                    neg_lr = tl.load(NEG_LR)
                    ratio = tl.load(RATIO + leaf)
                else:
                    neg_lr, ratio = 0.0, 0.0
            idx = tl.arange(0, BLOCK)
            if n >= BLOCK:
                _lamb_block(g, w, mu, nu, o, PART, pid, C, idx, n, gnorm, bc1, bc2,
                            neg_lr, ratio, decay, b1, omb1, b2, omb2, eps, wd, mgn,
                            CLIP, HAS_WD, MODE, False)
            else:
                _lamb_block(g, w, mu, nu, o, PART, pid, C, idx, n, gnorm, bc1, bc2,
                            neg_lr, ratio, decay, b1, omb1, b2, omb2, eps, wd, mgn,
                            CLIP, HAS_WD, MODE, True)

    @triton.jit
    def _lars_block(G, W, M, O, PART, pid, C, idx, n, neg_rate, wd, momentum,
                    MODE: tl.constexpr, MASKED: tl.constexpr):
        w = _ld(W, idx, n, MASKED)
        g = _ld(G, idx, n, MASKED) + wd * w
        if MODE == 0:
            tl.store(PART + pid, tl.sum(w * w, axis=0))
            tl.store(PART + C + pid, tl.sum(g * g, axis=0))
        else:
            m = momentum * _ld(M, idx, n, MASKED) + neg_rate * g
            if MODE == 1:
                _st(O, idx, n, w + m, MASKED)
            else:
                _st(M, idx, n, m, MASKED)
                _st(W, idx, n, _ld(O, idx, n, MASKED), MASKED)

    @triton.jit
    def _lars_kernel(BASE, OFFS, CHUNK_LEAF, CHUNK0, SIZES, FLAGS, L, PART, C,
                     NEG_RATE, OK, wd, momentum, MODE: tl.constexpr,
                     VEC: tl.constexpr, BLOCK: tl.constexpr):
        if MODE == 2:
            go = tl.load(OK) != 0
        else:
            go = True
        if go:
            pid, leaf, start, n = _locate(CHUNK_LEAF, CHUNK0, SIZES, BLOCK)
            g = _at(BASE, OFFS, 0, L, leaf, start, VEC)
            w = _at(BASE, OFFS, 1, L, leaf, start, VEC)
            m = _at(BASE, OFFS, 2, L, leaf, start, VEC)
            o = _at(BASE, OFFS, 3, L, leaf, start, VEC)
            if MODE == 0:
                neg_rate = 0.0
            else:
                neg_rate = tl.load(NEG_RATE + leaf)
            idx = tl.arange(0, BLOCK)
            if n >= BLOCK:
                _lars_block(g, w, m, o, PART, pid, C, idx, n, neg_rate, wd, momentum,
                            MODE, False)
            else:
                _lars_block(g, w, m, o, PART, pid, C, idx, n, neg_rate, wd, momentum,
                            MODE, True)

    _KERNELS = dict(sq=_sq_kernel, leaf_sums=_leaf_sums_kernel, copy=_copy_kernel,
                    lamb=_lamb_kernel, lars=_lars_kernel)
    return _KERNELS


def _launch(name: str, b: Bound, *args, **meta) -> None:
    if b.table.n_chunks:
        _kernels()[name][(b.table.n_chunks,)](
            *b.args(), *args, VEC=b.vec, BLOCK=CHUNK, num_warps=_WARPS,
            enable_fp_fusion=False, **meta)


def _leaf_sums(b: Bound, part: torch.Tensor) -> torch.Tensor:
    """``[R, L]``: each leaf's chunk partials (``part [R, C]``) summed in
    chunk order."""
    rows, table = part.shape[0], b.table
    out = torch.empty((rows, len(table)), dtype=torch.float32, device=part.device)
    _kernels()["leaf_sums"][(len(table), rows)](
        part, table.arrays(part.device)["chunk0"], out, table.n_chunks, len(table),
        BLOCK=_SUM_BLOCK, num_warps=4)
    return out


def _partials(b: Bound, rows: int) -> torch.Tensor:
    return torch.empty((rows, max(b.table.n_chunks, 1)), dtype=torch.float32,
                       device=b.base.device)


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A 0-d fp32 tensor on the card: a device scalar as it is, a host
    number filled there (no host read either way)."""
    if isinstance(x, torch.Tensor):
        if x.device != like.device or x.dtype != torch.float32 or x.numel() != 1:
            raise ValueError(f"a scalar operand must be one fp32 element on "
                             f"{like.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
        return x
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


def _vector(x: torch.Tensor, b: Bound) -> torch.Tensor:
    if (x.device != b.base.device or x.dtype != torch.float32
            or x.shape != (len(b.table),) or not x.is_contiguous()):
        raise ValueError(f"a per-leaf operand must be fp32 [{len(b.table)}] on "
                         f"{b.base.device}, got {x.dtype} {tuple(x.shape)}")
    return x


def sumsq(b: Bound, role: int = 0, divisor: Optional[float] = None) -> torch.Tensor:
    """``[L]``: each leaf's sum of squares of ``role`` (of ``x / divisor``,
    an IEEE division, where a divisor is given)."""
    if not b.on_card:
        return sumsq_plain(b.roles[role], divisor)
    part = _partials(b, 1)
    _launch("sq", b, part, 1.0 if divisor is None else float(divisor), ROLE=role,
            MODE=_SQ if divisor is None else _MEAN_SQ)
    sumsq.launches += 1
    return _leaf_sums(b, part)[0]


def all_finite(b: Bound, role: int) -> torch.Tensor:
    """A 0-d device bool: every element of every leaf of ``role`` finite."""
    if not b.on_card:
        return all_finite_plain(b.roles[role])
    part = _partials(b, 1)
    _launch("sq", b, part, 1.0, ROLE=role, MODE=_NONFINITE)
    all_finite.launches += 1
    return (_leaf_sums(b, part) == 0).all()


def scaled_copy(b: Bound, divisor: float, scale: Optional[torch.Tensor] = None) -> None:
    """Role 1 = role 0 / ``divisor`` (IEEE), times the 0-d ``scale``."""
    if not b.on_card:
        return scaled_copy_plain(b.roles[0], b.roles[1], divisor, scale)
    _launch("copy", b, b.base if scale is None else _scalar(scale, b.base),
            float(divisor), SCALED=scale is not None)
    scaled_copy.launches += 1


def _lamb(b: Bound, mode: int, hp, g_norm, bc1=None, bc2=None, neg_lr=None,
          ratio=None, ok=None, part=None) -> None:
    base = b.base
    clip = hp.max_grad_norm is not None
    _launch("lamb", b, base if part is None else part, b.table.n_chunks,
            _scalar(g_norm, base) if clip else base,
            base if bc1 is None else _scalar(bc1, base),
            base if bc2 is None else _scalar(bc2, base),
            base if neg_lr is None else _scalar(neg_lr, base),
            base if ratio is None else _vector(ratio, b),
            base if ok is None else ok.reshape(()).view(torch.uint8),
            hp.b1, 1 - hp.b1, hp.b2, 1 - hp.b2, hp.eps, hp.weight_decay,
            hp.max_grad_norm if clip else 0.0,
            CLIP=clip, HAS_WD=hp.weight_decay > 0.0, MODE=mode)


def lamb_norms(b: Bound, hp, g_norm, bc1, bc2) -> torch.Tensor:
    """``[2, L]``: each leaf's ``Σw²`` and ``Σu²``, ``u`` the Adam direction
    with weight decay (``hp``: ``b1``, ``b2``, ``eps``, ``weight_decay``,
    ``max_grad_norm``; roles G, P, MU, NU; the table's flags say where
    weight decay applies)."""
    if not b.on_card:
        return lamb_norms_plain(b, hp, g_norm, bc1, bc2)
    part = _partials(b, 2)
    _lamb(b, _NORMS, hp, g_norm, bc1, bc2, part=part)
    lamb_norms.launches += 1
    return _leaf_sums(b, part)


def lamb_candidate(b: Bound, hp, g_norm, bc1, bc2, neg_lr, ratio) -> None:
    """Role OUT = ``w + neg_lr · (u · ratio[leaf])``; nothing else written."""
    if not b.on_card:
        return lamb_candidate_plain(b, hp, g_norm, bc1, bc2, neg_lr, ratio)
    _lamb(b, _CANDIDATE, hp, g_norm, bc1, bc2, neg_lr, ratio)
    lamb_candidate.launches += 1


def lamb_commit(b: Bound, hp, g_norm, ok: torch.Tensor) -> None:
    """Where the 0-d device bool ``ok`` holds: the moments of this step into
    MU and NU, role OUT (the kept parameters) into P; else nothing."""
    if not b.on_card:
        return lamb_commit_plain(b, hp, g_norm, ok)
    _lamb(b, _COMMIT, hp, g_norm, ok=ok)
    lamb_commit.launches += 1


def _lars(b: Bound, mode: int, hp, neg_rate=None, ok=None, part=None) -> None:
    base = b.base
    _launch("lars", b, base if part is None else part, b.table.n_chunks,
            base if neg_rate is None else _vector(neg_rate, b),
            base if ok is None else ok.reshape(()).view(torch.uint8),
            hp.weight_decay, hp.momentum if mode else 0.0, MODE=mode)


def lars_norms(b: Bound, hp) -> torch.Tensor:
    """``[2, L]``: each leaf's ``Σw²`` and ``Σ(g + wd·w)²`` (``hp``:
    ``momentum``, ``weight_decay``; roles G, P)."""
    if not b.on_card:
        return lars_norms_plain(b, hp.weight_decay)
    part = _partials(b, 2)
    _lars(b, _NORMS, hp, part=part)
    lars_norms.launches += 1
    return _leaf_sums(b, part)


def lars_candidate(b: Bound, hp, neg_rate: torch.Tensor) -> None:
    """Role OUT = ``w + (momentum · m + neg_rate[leaf] · (g + wd·w))``
    (roles: gradients, parameters, momentum, out)."""
    if not b.on_card:
        return lars_candidate_plain(b, hp, neg_rate)
    _lars(b, _CANDIDATE, hp, neg_rate)
    lars_candidate.launches += 1


def lars_commit(b: Bound, hp, neg_rate: torch.Tensor, ok: torch.Tensor) -> None:
    """Where ``ok`` holds: the new momentum and the kept parameters (role
    3) in place; else nothing."""
    if not b.on_card:
        return lars_commit_plain(b, hp, neg_rate, ok)
    _lars(b, _COMMIT, hp, neg_rate, ok=ok)
    lars_commit.launches += 1


WRAPPERS = (sumsq, all_finite, scaled_copy, lamb_norms, lamb_candidate, lamb_commit,
            lars_norms, lars_candidate, lars_commit)
for _w in WRAPPERS:
    _w.launches = 0


@functools.lru_cache(maxsize=8)
def _table(sizes: tuple) -> LeafTable:
    return LeafTable(sizes)


def mean_clip(acc: Dict[str, torch.Tensor], n, cap: float) -> Dict[str, torch.Tensor]:
    """``acc / n`` per leaf, times ``min(cap / (‖acc / n‖ + 1e-12), 1)``
    where ``cap > 0``: a new dict of fp32 leaves, views of one buffer. The
    global norm is a fixed-order sum of per-leaf sums; with ``cap <= 0``
    only the division is made."""
    names, leaves = list(acc), list(acc.values())
    table = _table(tuple(t.numel() for t in leaves))
    out = table.empty_like(leaves)
    b = table.bind([leaves, out])
    scale = None
    if cap > 0:
        gnorm = torch.sqrt(sumsq(b, 0, divisor=n).sum())
        scale = torch.clamp_max(torch.full_like(gnorm, cap) / (gnorm + 1e-12), 1.0)
    scaled_copy(b, n, scale)
    return dict(zip(names, out))
