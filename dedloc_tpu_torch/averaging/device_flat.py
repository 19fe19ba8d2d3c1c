"""Device-resident flat gradient pipeline: flatten, quantize and stream the
mean-grad dict OFF the card without blocking the trainer's stream.

Port of ``dedloc_tpu/averaging/device_flat.py``. At a global-batch boundary
the fp32 gradient accumulator leaves the card as ONE flat buffer in the
averaging wire's layout (the JAX wire names sorted, each leaf in the JAX
element order: a ``Linear`` weight ``[out, in]`` goes as its ``[in, out]``
transpose, a ``Conv2d`` weight OIHW as HWIO). Everything before the copy runs on the card in plain PyTorch:

- **flatten** in spec order, then the ``grad_acc / n`` mean as a DIVISION
  (not a reciprocal multiply, so it matches the host path bit for bit);
- **contribution clip**: one global-norm reduce over the flat buffer;
- **error feedback**: the quantization residual lives on the card and is
  folded into the contribution (commit discipline as
  ``collaborative/error_feedback.py``);
- **quantize** under ``float16`` (a round-to-nearest cast) or ``uint8``
  (per block of ``DEFAULT_D2H_CHUNK`` elements: ``scale = (hi - lo) / 255``,
  0 -> 1.0, ``round`` half to even, clip), so the copy carries 16 or 8 bits
  per element;
- **streaming**: a side CUDA stream waits on an event recorded after the
  prepare and copies every chunk ``non_blocking`` into pinned,
  double-buffered host memory, then records a ``done`` event.
  ``FlatFetch.result()`` (on the averager's executor thread) waits on that
  event only, then decodes into the host buffer and returns a ``FlatTree``.

The device tensors a copy reads stay referenced by the fetch and are
``record_stream``-ed on the side stream, so the caching allocator cannot
hand their memory to the trainer while the copy still reads it. On CPU
tensors the same arithmetic runs with no stream and no copy.

Dtype contract: only floating-point leaves are accepted; integer or boolean
leaves are REFUSED with ``ValueError`` (the caller falls back to the host
path).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from dedloc_tpu_torch.averaging.partition import FlatTree, TreeLayout
from dedloc_tpu_torch.models.convert import grad_name, to_jax_layout
from dedloc_tpu_torch.telemetry import registry as telemetry
from dedloc_tpu_torch.telemetry.registry import monotonic_clock
from dedloc_tpu_torch.utils.device import divide
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# fp32 elements per D2H chunk (4 MB), and the uint8 quantization BLOCK:
# each chunk gets its own affine (lo, scale) grid
DEFAULT_D2H_CHUNK = 1 << 20

_WIRE_DTYPES = {"none": torch.float32, "float16": torch.float16,
                "uint8": torch.uint8}


def named_device_leaves(tree: Mapping[str, torch.Tensor]) -> List[Tuple[str, torch.Tensor]]:
    """(JAX wire name, leaf in the JAX element order) for a dict of
    gradients keyed by the port's parameter names: the same names the JAX
    package's ``named_device_leaves`` gives, so the sorted spec (and its
    ``spec_fingerprint``) matches a JAX peer's."""
    out = []
    for name, leaf in tree.items():
        jname, perm = grad_name(name, leaf.ndim)
        out.append((jname, to_jax_layout(leaf, perm)))
    return out


def _chunk_bounds(total: int, chunk: int) -> List[Tuple[int, int]]:
    bounds = []
    offset = 0
    while offset < total:
        bounds.append((offset, min(offset + chunk, total)))
        offset = bounds[-1][1]
    return bounds


def _build_prepare(order, total, chunk, compression, use_ef, use_clip) -> Callable:
    """The flatten(+mean+clip+EF+quantize+split) function for one (spec,
    options) signature: (leaves, n, cap, residual) -> (wire chunks,
    quantization meta, candidate residual or None)."""
    if compression not in _WIRE_DTYPES:
        raise ValueError(f"unknown compression {compression!r}")
    bounds = _chunk_bounds(total, chunk)

    def prepare(leaves, n: float, cap: float, residual):
        by_spec = [None] * len(leaves)
        for leaf, pos in zip(leaves, order):
            by_spec[pos] = leaf.to(torch.float32).reshape(-1)
        flat = (torch.cat(by_spec) if by_spec
                else torch.zeros((0,), dtype=torch.float32))
        # the mean as a DIVISION: x / 3 != x * (1 / 3) in fp32
        flat = divide(flat, n)
        if use_clip:
            gnorm = torch.sqrt(torch.dot(flat, flat))
            flat = flat * torch.clamp_max(
                torch.full_like(gnorm, cap) / (gnorm + 1e-12), 1.0)
        contrib = flat + residual if use_ef else flat

        if compression == "none":
            wire = tuple(contrib[lo:hi] for lo, hi in bounds)
            return wire, (), contrib if use_ef else None
        if compression == "float16":
            q = contrib.to(torch.float16)
            wire = tuple(q[lo:hi] for lo, hi in bounds)
            if not use_ef:
                return wire, (), None
            return wire, (), contrib - q.to(torch.float32)
        n_blocks = len(bounds)
        pad = n_blocks * chunk - total
        grid = torch.nn.functional.pad(contrib, (0, pad)).view(n_blocks, chunk)
        valid = (torch.arange(n_blocks * chunk, device=contrib.device)
                 .view(n_blocks, chunk) < total)
        inf = torch.full((), float("inf"), device=contrib.device)
        lo = torch.where(valid, grid, inf).amin(dim=1)
        hi = torch.where(valid, grid, -inf).amax(dim=1)
        # native.quantize_uint8 per block: scale (hi-lo)/255, 0 -> 1.0
        scale = divide(hi - lo, 255.0)
        scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
        q = torch.clamp(
            torch.round((grid - lo[:, None]) / scale[:, None]), 0, 255
        ).to(torch.uint8)
        wire = tuple(q[i, : b_hi - b_lo] for i, (b_lo, b_hi) in enumerate(bounds))
        if not use_ef:
            return wire, (lo, scale), None
        dq = q.to(torch.float32) * scale[:, None] + lo[:, None]
        return wire, (lo, scale), contrib - dq.reshape(-1)[:total]

    return prepare


class _HostSlot:
    """One of the pipeline's two host buffers: the fp32 output the
    ``FlatTree`` views, and (on the card) the pinned staging the side
    stream copies the wire chunks and the uint8 meta into."""

    def __init__(self, total: int, n_blocks: int, compression: str,
                 pinned: bool) -> None:
        self.pinned = pinned
        if not pinned:
            self.out = np.empty((total,), np.float32)
            return
        wire_dtype = _WIRE_DTYPES[compression]
        if compression == "none":
            # fp32 needs no decode: the pinned staging IS the output
            self.stage = torch.empty((total,), dtype=wire_dtype, pin_memory=True)
            self.out = self.stage.numpy()
        else:
            self.stage = torch.empty((total,), dtype=wire_dtype, pin_memory=True)
            self.out = np.empty((total,), np.float32)
        self.meta = tuple(
            torch.empty((n_blocks,), dtype=torch.float32, pin_memory=True)
            for _ in range(2 if compression == "uint8" else 0))


class FlatFetch:
    """One in-flight device->host transfer of a flat contribution.

    ``result()`` waits for the copy's ``done`` event, decodes into the
    pipeline's host buffer and returns a ``FlatTree`` over it; it is
    idempotent and thread-safe (the averager resolves it on an executor
    thread, overlapped with matchmaking). ``exposed_wait_s`` is how long
    the FIRST ``result()`` call blocked: the part of the transfer nothing
    else hid.
    """

    def __init__(self, pipeline: "DeviceFlatPipeline", wire_chunks, quant_meta,
                 new_residual, slot: _HostSlot, done: Optional[torch.cuda.Event]):
        self.pipeline = pipeline
        self.spec = pipeline.spec
        self._wire = wire_chunks  # kept alive until the copy has landed
        self._meta = quant_meta
        self._new_residual = new_residual
        self._slot = slot
        self._done = done
        self._lock = threading.Lock()
        self._result: Optional[FlatTree] = None
        self.launched_at = monotonic_clock()
        self.exposed_wait_s = 0.0
        self.wire_bytes = sum(
            c.numel() * c.element_size() for c in wire_chunks
        ) + sum(m.numel() * m.element_size() for m in quant_meta)

    def _host_wire(self):
        """(wire chunks, meta) as CPU tensors, once the copy has landed."""
        if self._done is None:
            return list(self._wire), list(self._meta)
        self._done.synchronize()
        stage = self._slot.stage
        chunks = [stage[lo:hi] for lo, hi in self.pipeline.bounds]
        return chunks, list(self._slot.meta)

    def result(self) -> FlatTree:
        with self._lock:
            if self._result is not None:
                return self._result
            t0 = monotonic_clock()
            pipeline = self.pipeline
            buf = self._slot.out
            out = torch.from_numpy(buf)
            chunks, meta = self._host_wire()
            # the decode runs as torch CPU copies (vectorised, threaded): an
            # exact widen for fp16, and per uint8 block the same fp32
            # multiply then add as the JAX package's numpy decode
            if pipeline.compression == "uint8":
                lo, scale = (m.tolist() for m in meta)
                for i, (lo_i, hi_i) in enumerate(pipeline.bounds):
                    out[lo_i:hi_i].copy_(chunks[i]).mul_(scale[i]).add_(lo[i])
            elif not (self._done is not None and pipeline.compression == "none"):
                # fp32 passthrough from CPU tensors, or the fp16 widen
                for (lo_i, hi_i), chunk in zip(pipeline.bounds, chunks):
                    out[lo_i:hi_i].copy_(chunk)
            self.exposed_wait_s = max(0.0, monotonic_clock() - t0)
            self._wire = ()  # release the device tensors
            self._meta = ()
            self._result = pipeline.layout.tree_view(buf)
            pipeline._record_fetch(self)
            return self._result


class DeviceFlatPipeline:
    """The flat seam for one stable gradient schema.

    Built lazily from the first boundary's gradient dict; ``fetch()`` runs
    the prepare and starts the copies and returns a ``FlatFetch``. Host
    buffers are DOUBLE-buffered: at most two fetches may be outstanding,
    and the returned ``FlatTree`` is valid until the next-but-one
    ``fetch``.

    Error feedback mirrors ``collaborative/error_feedback.py``:
    ``fetch(use_ef=True)`` folds the committed residual into the
    contribution and computes this round's candidate on the card;
    ``commit(fetch)`` adopts it only when the round landed,
    ``reset_residual()`` drops it after a resync. The device-quantized
    representation IS what the host sees, so even a singleton round has
    crossed the lossy leg and commits (the optimizer makes that switch).
    """

    def __init__(
        self,
        spec: Sequence[Tuple[str, Tuple[int, ...], np.dtype]],
        order: Sequence[int],
        compression: str = "none",
        chunk_elems: int = DEFAULT_D2H_CHUNK,
        telemetry_registry=None,
    ) -> None:
        self.spec = list(spec)
        self.order = tuple(order)
        self.layout = TreeLayout(self.spec)
        self.total = self.layout.total_size
        self.compression = compression
        self.chunk_elems = max(1, int(chunk_elems))
        self.bounds = _chunk_bounds(self.total, self.chunk_elems)
        self.telemetry = telemetry_registry
        self._prepare_cache: Dict[Tuple[bool, bool], Callable] = {}
        self._residual: Optional[torch.Tensor] = None  # flat [total], lazily zeros
        self._slots: List[_HostSlot] = []
        self._next_slot = 0
        self._stream = None  # side stream for the copies, on first card fetch
        self.fetches = 0
        self.wire_bytes_total = 0

    # ------------------------------------------------------------- factory

    @classmethod
    def for_tree(
        cls,
        tree: Mapping[str, torch.Tensor],
        compression: str = "none",
        chunk_elems: int = DEFAULT_D2H_CHUNK,
        telemetry_registry=None,
    ) -> "DeviceFlatPipeline":
        """Build from a gradient dict. Raises ``ValueError`` on
        non-floating leaves — the refusal contract."""
        named = named_device_leaves(tree)
        for name, leaf in named:
            if not leaf.dtype.is_floating_point:
                raise ValueError(
                    f"device flat pipeline refuses non-float leaf {name!r} "
                    f"({leaf.dtype}): the fp32 flat layout cannot represent it"
                )
        names = sorted(name for name, _leaf in named)
        index = {n: i for i, n in enumerate(names)}
        spec = [None] * len(named)
        order = []
        for name, leaf in named:
            spec[index[name]] = (name, tuple(leaf.shape), np.dtype(np.float32))
            order.append(index[name])
        return cls(spec, order, compression=compression,
                   chunk_elems=chunk_elems, telemetry_registry=telemetry_registry)

    def matches_tree(self, tree: Mapping[str, torch.Tensor]) -> bool:
        named = named_device_leaves(tree)
        if len(named) != len(self.spec):
            return False
        by_name = {name: tuple(leaf.shape) for name, leaf in named}
        return all(by_name.get(name) == tuple(shape)
                   for name, shape, _dtype in self.spec)

    # ------------------------------------------------------------ EF state

    @property
    def ef_enabled(self) -> bool:
        return self.compression != "none"

    def _residual_dev(self, device) -> torch.Tensor:
        if self._residual is None:
            self._residual = torch.zeros((self.total,), dtype=torch.float32,
                                         device=device)
        return self._residual

    def commit(self, fetch: FlatFetch) -> None:
        """Adopt the round's residual — call only when the round landed."""
        if fetch._new_residual is not None:
            self._residual = fetch._new_residual

    def reset_residual(self) -> None:
        """Drop the carried residual (post-resync: it belongs to gradients
        computed on params this peer no longer holds)."""
        self._residual = None

    def residual_norm(self) -> float:
        if self._residual is None:
            return 0.0
        return float(torch.sqrt(torch.dot(self._residual, self._residual)))

    # --------------------------------------------------------------- fetch

    def _prepare_fn(self, use_ef: bool, use_clip: bool) -> Callable:
        key = (use_ef, use_clip)
        fn = self._prepare_cache.get(key)
        if fn is None:
            fn = _build_prepare(self.order, self.total, self.chunk_elems,
                                self.compression, use_ef, use_clip)
            self._prepare_cache[key] = fn
        return fn

    def _slot(self, pinned: bool) -> _HostSlot:
        if not self._slots or self._slots[0].pinned != pinned:
            self._slots = [
                _HostSlot(self.total, len(self.bounds), self.compression, pinned)
                for _ in range(2)
            ]
            self._next_slot = 0
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        return slot

    @torch.no_grad()
    def fetch(
        self,
        tree: Mapping[str, torch.Tensor],
        n: float = 1.0,
        clip_cap: Optional[float] = None,
        use_ef: bool = True,
    ) -> FlatFetch:
        """Run the prepare for ``tree`` and start its copy to the host.

        ``n`` folds the accumulator mean (the micro-batch count);
        ``clip_cap`` enables the contribution clip at that cap; ``use_ef``
        gates the residual fold (False for zero-weight/gated rounds).
        """
        use_ef = bool(use_ef and self.ef_enabled)
        use_clip = clip_cap is not None
        leaves = [leaf for _name, leaf in named_device_leaves(tree)]
        device = leaves[0].device if leaves else torch.device("cpu")
        residual = self._residual_dev(device) if use_ef else None
        wire, meta, new_residual = self._prepare_fn(use_ef, use_clip)(
            leaves, float(n), float(clip_cap) if use_clip else 0.0, residual)
        if device.type != "cuda":
            return FlatFetch(self, wire, meta, new_residual,
                             self._slot(pinned=False), done=None)
        slot = self._slot(pinned=True)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=device)
        ready = torch.cuda.Event()
        ready.record()  # after the prepare, on the trainer's stream
        done = torch.cuda.Event()
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(ready)
            for (lo, hi), chunk in zip(self.bounds, wire):
                slot.stage[lo:hi].copy_(chunk, non_blocking=True)
                chunk.record_stream(self._stream)
            for host, m in zip(slot.meta, meta):
                host.copy_(m, non_blocking=True)
                m.record_stream(self._stream)
            done.record()
        return FlatFetch(self, wire, meta, new_residual, slot, done=done)

    def _record_fetch(self, fetch: FlatFetch) -> None:
        self.fetches += 1
        self.wire_bytes_total += fetch.wire_bytes
        tele = telemetry.resolve(self.telemetry)
        if tele is not None:
            tele.counter("opt.d2h_bytes").inc(fetch.wire_bytes)
            tele.counter("opt.d2h_exposed_s").inc(fetch.exposed_wait_s)
            tele.histogram("opt.d2h_wait_s").observe(fetch.exposed_wait_s)
            tele.event(
                "opt.d2h_stream",
                bytes=fetch.wire_bytes,
                exposed_s=fetch.exposed_wait_s,
                chunks=len(self.bounds),
                compression=self.compression,
            )
