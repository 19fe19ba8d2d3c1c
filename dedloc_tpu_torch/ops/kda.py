"""The chunked gated delta rule of Kimi Delta Attention (KDA; Kimi Linear,
arXiv 2510.26692): hand-written CUDA kernels on the card (``csrc/kda.cu``,
built by ``_build.py``), their plain PyTorch mirror on the CPU, and the
token recurrence the two are held to.

Per head, with a state ``S`` of ``[d_k, d_v]`` (fp32, ``S_0 = 0``), for
each token ``t``, ``q_t, k_t [d_k]``, ``v_t [d_v]``, the per-channel log
decay ``g_t [d_k]`` (``α_t = exp(g_t)``) and the write strength ``β_t``::

    S_t = (I - β_t k_t k_tᵀ) Diag(α_t) S_{t-1} + β_t k_t v_tᵀ
    o_t = scale · S_tᵀ q_t

The chunked form (the WY representation of the delta rule). Within a chunk
of ``C`` tokens that starts from the state ``S_0``, with the cumulative
decay ``G_t = g_1 + … + g_t`` (per channel, so ``G`` falls through the
chunk) and ``E_ts = exp(G_t - G_s)`` taken per channel for ``s <= t``::

    A_ts = β_t Σ_c k_tc k_sc E_tsc        (s < t)     T = (I + A)^-1
    M_ts = Σ_c q_tc k_sc E_tsc            (s <= t)
    W = T diag(β) (K ⊙ e^G)   Ũ = T diag(β) V   U = Ũ - W S_0
    O = scale · ((Q ⊙ e^G) S_0 + M U)
    S_C = Diag(e^{G_C}) S_0 + (K ⊙ e^{G_C - G})ᵀ U

Every exponential is of a cumulative decay difference that is at most 0:
``E`` is formed per channel and never factored as ``e^{G_t} e^{-G_s}``, so
a chunk whose decay sums far below -88 (fp32's ``exp`` overflows at +88)
stays finite; such terms underflow to 0, which is their value. The chunk is
``CHUNK`` = 16 tokens. The backward needs no product with the state for
``dA``: it is ``-(Tᵀ dU) Uᵀ`` (``_bwd_intra``).

Kernels (``B`` sequences, ``H`` heads of ``HEAD_DIM`` = 128, ``N``
chunks; the source's header says what bounds each and how its design
answers it):

- ``kda_fwd_intra_kernel`` (grid ``N × B·H``): a chunk's ``A``, ``M``,
  ``T`` (forward substitution), ``W`` (bf16) and ``Ũ`` (fp32);
- ``kda_fwd_state_kernel`` (grid ``B·H × d_v / BV``): walks the chunks in
  order with ``BV`` columns of ``S`` in shared memory: stores each chunk's
  ``S_0``, ``U`` (over ``Ũ``) and ``O``; at the end the final state's sum
  of squares;
- ``kda_bwd_state_kernel`` (grid ``B·H × d_v / BV``): walks the chunks in
  reverse with ``dS`` (the gradient of the state at a chunk's end): stores
  it per chunk and ``dU = scale Mᵀ dO + (K ⊙ e^{G_C-G}) dS``;
- ``kda_bwd_intra_kernel`` (grid ``N × B·H``): a chunk's ``dq, dk, dv,
  dg, dβ`` from ``S_0``, ``dS``, ``U``, ``dU`` and ``dO`` (the derivation
  is the plain mirror's ``_bwd_intra``).

Products with the state (``W S``, ``(Q ⊙ e^G) S``, ``M U``, ``Kᵀ U`` and
their transposes in the backward) take bf16 inputs and accumulate in fp32
on the tensor cores (WMMA); the chunk's own ``[C, C]`` algebra (``A``,
``M``, ``T`` and the products with ``T``) runs in fp32 on the CUDA cores.
``g``, ``β``, ``G``, the state and every gradient accumulator are fp32. No
atomics: every output element is written by one thread, and sums across
threads are taken in a fixed order.

Rows past the sequence's end read as ``q = k = v = g = β = 0``: such a row
leaves the state as it is and writes nothing. ``kda_fwd`` gives each
head's final-state Frobenius norm ``[B, H]`` from the sums of squares the
forward state kernel leaves.

``kda_chunk`` is the op (an autograd function: the kernels on the card,
``kda_chunk_plain``'s mirror on the CPU); ``kda_recurrent`` is the literal
token loop, for tests. ``<wrapper>.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from dedloc_tpu_torch.ops import _build
from dedloc_tpu_torch.utils.device import on_card

CHUNK = 16  # tokens a chunk (``C`` in ``csrc/kda.cu``)
HEAD_DIM = 128  # d_k = d_v the kernels take
BV = 32  # state columns a block of the state kernels holds


# ------------------------------------------------------------ the recurrence


def kda_recurrent(q, k, v, g, beta, scale: float):
    """``o [B, S, H, d_v]`` by the token loop, in q's dtype (fp32 math):
    the definition the chunked forms are held to."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    state = q.new_zeros(b, h, dk, dv, dtype=torch.float32)
    out = []
    for t in range(s):
        qt, kt, vt = q[:, t].float(), k[:, t].float(), v[:, t].float()
        bt = beta[:, t].float()[..., None]
        state = state * g[:, t].float().exp()[..., None]
        pred = torch.einsum("bhkv,bhk->bhv", state, kt)
        state = state + torch.einsum("bhk,bhv->bhkv", kt, bt * (vt - pred))
        out.append(scale * torch.einsum("bhkv,bhk->bhv", state, qt))
    return torch.stack(out, 1).to(q.dtype)


# ---------------------------------------------------------- the plain mirror


def _chunked(x: torch.Tensor, c: int) -> torch.Tensor:
    """``[B, S, H, ...]`` -> ``[B, H, N, C, ...]`` (fp32), zero-padded."""
    b, s, h = x.shape[:3]
    n = -(-s // c)
    x = x.float()
    if n * c != s:
        x = torch.cat([x, x.new_zeros((b, n * c - s) + tuple(x.shape[2:]))], 1)
    x = x.reshape((b, n, c, h) + tuple(x.shape[3:]))
    return x.movedim(3, 1)


def _unchunked(x: torch.Tensor, s: int) -> torch.Tensor:
    b, h, n, c = x.shape[:4]
    return x.movedim(1, 3).reshape((b, n * c, h) + tuple(x.shape[4:]))[:, :s]


def _decay(g: torch.Tensor):
    """(G, e^{G_t - G_s} [.., C, C, K] below and on the diagonal, 0 above)."""
    big_g = g.cumsum(-2)
    c = g.shape[-2]
    diff = big_g[..., :, None, :] - big_g[..., None, :, :]
    lower = torch.ones(c, c, dtype=torch.bool, device=g.device).tril()
    return big_g, diff.masked_fill(~lower[..., None], float("-inf")).exp()


def _fwd_intra(q, k, v, g, beta):
    """Per chunk (``[.., C, ·]``, fp32): A (with β), M, T, W, Ũ, and the
    unweighted ``Â`` of A."""
    c = g.shape[-2]
    big_g, e = _decay(g)
    strict = torch.ones(c, c, dtype=torch.bool, device=g.device).tril(-1)
    a_hat = (k[..., :, None, :] * k[..., None, :, :] * e).sum(-1) * strict
    m = (q[..., :, None, :] * k[..., None, :, :] * e).sum(-1)
    a = beta[..., None] * a_hat
    eye = torch.eye(c, device=g.device)
    t = torch.linalg.solve_triangular(eye + a, eye.expand_as(a), upper=False,
                                      unitriangular=True)
    w = t @ (beta[..., None] * k * big_g.exp())
    u_t = t @ (beta[..., None] * v)
    return big_g, a_hat, m, t, w, u_t


def _ends(q, k, big_g):
    """(Q ⊙ e^G, K ⊙ e^{G_C - G}, e^{G_C}) of each chunk."""
    last = big_g[..., -1:, :]
    return q * big_g.exp(), k * (last - big_g).exp(), last[..., 0, :].exp()


def _fwd_states(q, k, big_g, w, u_t, m, scale):
    """The chunks in order: (each chunk's starting state ``[B, H, N, K,
    V]``, U, O, the final state)."""
    qg, kend, gend = _ends(q, k, big_g)
    b, h, n, c, dk = q.shape
    state = q.new_zeros(b, h, dk, u_t.shape[-1])
    states, us, os_ = [], [], []
    for i in range(n):
        states.append(state)
        u = u_t[:, :, i] - w[:, :, i] @ state
        os_.append(scale * (qg[:, :, i] @ state + m[:, :, i] @ u))
        state = gend[:, :, i, :, None] * state + kend[:, :, i].transpose(-1, -2) @ u
        us.append(u)
    return torch.stack(states, 2), torch.stack(us, 2), torch.stack(os_, 2), state


def _bwd_states(q, k, big_g, w, m, do, scale):
    """The chunks in reverse: (the gradient of each chunk's end state, dU)."""
    qg, kend, gend = _ends(q, k, big_g)
    b, h, n, c, dk = q.shape
    ds = q.new_zeros(b, h, dk, do.shape[-1])
    dss, dus = [None] * n, [None] * n
    for i in reversed(range(n)):
        dss[i] = ds
        du = scale * m[:, :, i].transpose(-1, -2) @ do[:, :, i] + kend[:, :, i] @ ds
        ds = (gend[:, :, i, :, None] * ds + scale * qg[:, :, i].transpose(-1, -2)
              @ do[:, :, i] - w[:, :, i].transpose(-1, -2) @ du)
        dus[i] = du
    return torch.stack(dss, 2), torch.stack(dus, 2)


def _bwd_intra(q, k, v, g, beta, s0, ds, u, du, do, scale):
    """Per chunk, from its start state ``s0``, its end state's gradient
    ``ds``, U, dU and dO: (dq, dk, dv, dg, dβ).

    Through ``O = scale(QΓ S_0 + M U)``, ``S_C = Γ_C S_0 + K_endᵀ U``,
    ``U = Ũ - W S_0``, ``W = T B_K``, ``Ũ = T B_V`` (``B_K = diag(β)
    KΓ``, ``B_V = diag(β) V``) and ``T = (I + A)^-1``:
    ``dQΓ = scale dO S_0ᵀ``, ``dM = scale dO Uᵀ`` (s <= t), ``dW = -dU
    S_0ᵀ``, ``dK_end = U dSᵀ``, ``dΓ_C = Σ_v S_0 ⊙ dS``, ``dB_K = Tᵀ dW``,
    ``dB_V = Tᵀ dU`` and ``dA = -Tᵀ dT Tᵀ`` (s < t) with ``dT = dW B_Kᵀ +
    dU B_Vᵀ``; since ``B_K S_0 = (I + A)(Ũ - U)`` and ``B_V = (I + A) Ũ``,
    ``dT = dU Uᵀ (I + A)ᵀ`` and ``dA = -dB_V Uᵀ``: no product with the
    state. The per-channel products ``Σ_c x_tc y_sc E_tsc`` of ``A`` and
    ``M`` give, with ``X = diag(β) dA``, ``R1_t = Σ_s X_ts k_s E_ts``,
    ``R2_t = Σ_s dM_ts k_s E_ts`` and ``Col_s = Σ_t (X_ts k_t + dM_ts q_t)
    E_ts``: ``dq = dQΓ ⊙ Γ + R2``, ``dk = R1 + Col + β dB_K ⊙ Γ + dK_end
    ⊙ e^{G_C - G}`` and the gradient of ``G``: ``k ⊙ (R1 - Col) + q ⊙ R2 +
    dQΓ ⊙ QΓ + β dB_K ⊙ KΓ - dK_end ⊙ K_end``, plus ``Σ_t dK_end ⊙ K_end
    + dΓ_C ⊙ Γ_C`` on ``G_C``; ``dg`` is its reverse cumulative sum in the
    chunk."""
    c = g.shape[-2]
    big_g, a_hat, _m, t, _w, _ut = _fwd_intra(q, k, v, g, beta)
    e = _decay(g)[1]
    qg, kend, gend = _ends(q, k, big_g)
    eg = big_g.exp()
    kg = k * eg
    tt = t.transpose(-1, -2)
    lower = torch.ones(c, c, dtype=torch.bool, device=g.device).tril()
    strict = lower.tril(-1)
    dqg = scale * do @ s0.transpose(-1, -2)
    dm = scale * (do @ u.transpose(-1, -2)) * lower
    dw = -du @ s0.transpose(-1, -2)
    dkend = u @ ds.transpose(-1, -2)
    dgend = (s0 * ds).sum(-1)
    dbk, dbv = tt @ dw, tt @ du
    da = -(dbv @ u.transpose(-1, -2)) * strict
    x = beta[..., None] * da
    r1 = (x[..., None] * k[..., None, :, :] * e).sum(-2)
    r2 = (dm[..., None] * k[..., None, :, :] * e).sum(-2)
    col = ((x[..., None] * k[..., :, None, :] + dm[..., None] * q[..., :, None, :])
           * e).sum(-3)
    dq = dqg * eg + r2
    dk = r1 + col + beta[..., None] * dbk * eg + dkend * (big_g[..., -1:, :] - big_g).exp()
    dbig = (k * (r1 - col) + q * r2 + dqg * qg + beta[..., None] * dbk * kg
            - dkend * kend)
    dlast = (dkend * kend).sum(-2) + dgend * gend
    dg = dbig.flip(-2).cumsum(-2).flip(-2) + dlast[..., None, :]
    dv = beta[..., None] * dbv
    dbeta = (da * a_hat).sum(-1) + (dbk * kg).sum(-1) + (dbv * v).sum(-1)
    return dq, dk, dv, dg, dbeta


def _per_group(fn, n: int, group: int, *tensors):
    """``fn`` over groups of at most ``group`` chunks (dim 2), results
    concatenated: bounds the ``[C, C, K]`` products' memory."""
    outs = [fn(*(x[:, :, i:i + group] for x in tensors)) for i in range(0, n, group)]
    return tuple(torch.cat(parts, 2) for parts in zip(*outs))


GROUP = 64  # chunks the mirror's per-chunk algebra takes at once


def kda_fwd_plain(q, k, v, g, beta, scale: float, chunk: int = CHUNK):
    """The kernels' forward in PyTorch (fp32 math): (o in q's dtype,
    [B, H] final-state norms, what the backward needs)."""
    s = q.shape[1]
    cq, ck, cv, cg, cb = (_chunked(x, chunk) for x in (q, k, v, g, beta))
    n = cq.shape[2]
    big_g, _ah, m, _t, w, u_t = _per_group(_fwd_intra, n, GROUP, cq, ck, cv, cg, cb)
    s0, u, o, final = _fwd_states(cq, ck, big_g, w, u_t, m, scale)
    norm = final.pow(2).sum((-1, -2)).sqrt()
    return _unchunked(o, s).to(q.dtype), norm, (s0, u, m, w)


def kda_bwd_plain(q, k, v, g, beta, scale: float, saved, do, chunk: int = CHUNK):
    """The kernels' backward in PyTorch: (dq, dk, dv, dg, dβ)."""
    s = q.shape[1]
    s0, u, m, w = saved
    cq, ck, cv, cg, cb = (_chunked(x, chunk) for x in (q, k, v, g, beta))
    cdo = _chunked(do, chunk)
    big_g = cg.cumsum(-2)
    ds, du = _bwd_states(cq, ck, big_g, w, m, cdo, scale)
    n = cq.shape[2]
    grads = _per_group(lambda *a: _bwd_intra(*a, scale), n, GROUP,
                       cq, ck, cv, cg, cb, s0, ds, u, du, cdo)
    dq, dk, dv, dg, db = (_unchunked(x, s) for x in grads)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dg.to(g.dtype),
            db.to(beta.dtype))


def kda_chunk_plain(q, k, v, g, beta, scale: float, chunk: int = CHUNK):
    """The chunked form in PyTorch with autograd's gradients: (o, [B, H]
    final-state norms). The CPU tests hold the mirror's hand-written
    backward to it."""
    s = q.shape[1]
    cq, ck, cv, cg, cb = (_chunked(x, chunk) for x in (q, k, v, g, beta))
    big_g, _ah, m, _t, w, u_t = _fwd_intra(cq, ck, cv, cg, cb)
    _s0, _u, o, final = _fwd_states(cq, ck, big_g, w, u_t, m, scale)
    return _unchunked(o, s).to(q.dtype), final.pow(2).sum((-1, -2)).sqrt().detach()


# ------------------------------------------------------------------ kernels

_LIB = None


def _lib() -> ctypes.CDLL:
    """``csrc/kda.cu``, built at first use (``_build.py``)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("kda")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.kda_fwd_intra.argtypes = [p] * 8 + [i] * 3 + [p]
        lib.kda_fwd_state.argtypes = [p] * 9 + [i] * 3 + [f, p]
        lib.kda_bwd_state.argtypes = [p] * 8 + [i] * 3 + [f, p]
        lib.kda_bwd_intra.argtypes = [p] * 15 + [i] * 3 + [f, p]
        for fn in (lib.kda_fwd_intra, lib.kda_fwd_state, lib.kda_bwd_state,
                   lib.kda_bwd_intra):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _check(q, k, v, g, beta) -> None:
    b, s, h, dk = q.shape
    if k.shape != q.shape or g.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"g {tuple(g.shape)}: expected [B, S, H, d] each")
    if beta.shape != (b, s, h):
        raise ValueError(f"beta {tuple(beta.shape)}: expected {(b, s, h)}")
    if dk != HEAD_DIM:
        raise ValueError(f"d_k = d_v = {dk}: the kernels take {HEAD_DIM}")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h}: the grids take at most 65535")
    for name, x, dtype in (("q", q, torch.bfloat16), ("k", k, torch.bfloat16),
                           ("v", v, torch.bfloat16), ("g", g, torch.float32),
                           ("beta", beta, torch.float32)):
        if x.dtype != dtype:
            raise TypeError(f"{name}: the kernels take {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")


def launch_fwd_intra(q, k, v, g, beta, w, u, m):
    """``kda_fwd_intra_kernel``: ``w`` (bf16, q's shape), ``u`` (Ũ, fp32,
    v's shape) and ``m`` (``[B·H, N, C, C]`` fp32) written."""
    b, s, h, _ = q.shape
    _raise_on(_lib().kda_fwd_intra(*_ptrs(q, k, v, g, beta, w, u, m), b, s, h, _stream(q)),
              "kda_fwd_intra")


def launch_fwd_state(q, k, g, w, u, m, o, s0, ss, scale: float):
    """``kda_fwd_state_kernel``: ``u`` turned from Ũ into U in place; ``o``,
    the chunks' starting states ``s0 [B·H, N, d_k, d_v]`` and the final
    states' sums of squares ``ss [B·H, d_v / BV]`` written."""
    b, s, h, _ = q.shape
    _raise_on(_lib().kda_fwd_state(*_ptrs(q, k, g, w, u, m, o, s0, ss), b, s, h, scale,
                                   _stream(q)), "kda_fwd_state")


def launch_bwd_state(q, k, g, w, m, do, dh, du, scale: float):
    """``kda_bwd_state_kernel``: each chunk's end-state gradient ``dh`` and
    ``du`` written."""
    b, s, h, _ = q.shape
    _raise_on(_lib().kda_bwd_state(*_ptrs(q, k, g, w, m, do, dh, du), b, s, h, scale,
                                   _stream(q)), "kda_bwd_state")


def launch_bwd_intra(q, k, v, g, beta, s0, dh, u, du, do, dq, dk, dv, dg, dbeta,
                     scale: float):
    """``kda_bwd_intra_kernel``: dq, dk, dv, dg and dβ written."""
    b, s, h, _ = q.shape
    _raise_on(_lib().kda_bwd_intra(*_ptrs(q, k, v, g, beta, s0, dh, u, du, do, dq, dk, dv,
                                          dg, dbeta), b, s, h, scale, _stream(q)),
              "kda_bwd_intra")


def kda_fwd(q, k, v, g, beta, scale: float):
    """(o, [B, H] final-state norms, what the backward needs): the forward
    kernels, or the plain mirror for CPU tensors."""
    if not on_card(q, "KDA chunk"):
        return kda_fwd_plain(q, k, v, g, beta, scale)
    _check(q, k, v, g, beta)
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    n = -(-s // CHUNK)
    w = torch.empty(q.shape, device=q.device, dtype=torch.bfloat16)
    u = torch.empty(v.shape, device=q.device, dtype=torch.float32)
    m = torch.empty((b * h, n, CHUNK, CHUNK), device=q.device, dtype=torch.float32)
    launch_fwd_intra(q, k, v, g, beta, w, u, m)
    o = torch.empty(v.shape, device=q.device, dtype=q.dtype)
    s0 = torch.empty((b * h, n, dk, dv), device=q.device, dtype=torch.float32)
    ss = torch.empty((b * h, dv // BV), device=q.device, dtype=torch.float32)
    launch_fwd_state(q, k, g, w, u, m, o, s0, ss, scale)
    kda_fwd.launches += 2
    return o, ss.sum(-1).sqrt().view(b, h), (s0, u, m, w)


def kda_bwd(q, k, v, g, beta, scale: float, saved, do):
    """(dq, dk, dv, dg, dβ): the backward kernels, or the plain mirror."""
    if not on_card(q, "KDA chunk"):
        return kda_bwd_plain(q, k, v, g, beta, scale, saved, do)
    s0, u, m, w = saved
    do = do.contiguous()
    if do.dtype != torch.bfloat16:
        raise TypeError(f"dO: the kernels take bf16, got {do.dtype}")
    dh = torch.empty_like(s0)
    du = torch.empty_like(u)
    launch_bwd_state(q, k, g, w, m, do, dh, du, scale)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dg, dbeta = torch.empty_like(g), torch.empty_like(beta)
    launch_bwd_intra(q, k, v, g, beta, s0, dh, u, du, do, dq, dk, dv, dg, dbeta, scale)
    kda_bwd.launches += 2
    return dq, dk, dv, dg, dbeta


kda_fwd.launches = 0
kda_bwd.launches = 0


class _KdaChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, g, beta, scale):
        o, norm, saved = kda_fwd(q, k, v, g, beta, scale)
        ctx.mark_non_differentiable(norm)
        ctx.save_for_backward(q, k, v, g, beta, *saved)
        ctx.scale = scale
        return o, norm

    @staticmethod
    def backward(ctx, do, _dnorm):
        q, k, v, g, beta, *saved = ctx.saved_tensors
        return (*kda_bwd(q, k, v, g, beta, ctx.scale, saved, do), None)


def kda_chunk(q, k, v, g, beta, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o ``[B, S, H, d_v]`` in q's dtype, each head's final-state Frobenius
    norm ``[B, H]`` fp32, no gradient) of the gated delta rule over ``q, k
    [B, S, H, d_k]``, ``v [B, S, H, d_v]`` (bf16 on the card), ``g [B, S,
    H, d_k]`` (log decay, <= 0) and ``beta [B, S, H]`` (fp32 both)."""
    return _KdaChunk.apply(q, k, v, g, beta, scale)
