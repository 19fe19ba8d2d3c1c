"""The slice mesh over ``torch.distributed`` ranks, its placement and its
collectives.

Port of ``dedloc_tpu/parallel/mesh.py``. A JAX slice is one process driving
N devices under GSPMD; here a slice is N ranks, one per mesh device,
launched by ``torchrun``::

    python -m torch.distributed.run --nproc_per_node N \\
        -m dedloc_tpu_torch.roles.trainer --training.mesh_devices N ...

and the slice is still ONE collaboration peer (``collaborative/slice.py``).

The mapping, decided once for the whole port:

- **Ranks and axes.** Rank r sits at the row-major coordinates of r in the
  mesh shape, axes in the order they are named (the JAX ``Mesh`` over
  ``np.array(devices).reshape(shape)``). Every subset of axes gets its
  process groups when the mesh is made, so a collective over ``("data",
  "seq")`` is one call.
- **Devices.** Rank r takes ``cuda:(device_offset + r)`` when the box has
  a card for every rank (``make_mesh``'s ``device_offset`` is JAX's);
  with fewer cards the ranks share the cards from the offset on, round
  robin. On the CPU every rank runs on the host.
- **Backend**, chosen before the process group exists (``placement``):
  NCCL when every rank has its own card, gloo on the CPU and when ranks
  share a card (NCCL refuses two ranks on one device). An NCCL failure
  raises; nothing falls back to another backend.
- **Host staging.** On a gloo group a collective on a CUDA tensor copies
  through a host buffer, inside the collectives below, and counts the bytes
  it moves each way in ``STAGING.bytes``. Compute never leaves the card.
- **Explicit local shards.** Each rank holds plain tensors, its shard of
  each sharded leaf (``parallel/sharding.py``); the model inserts the
  collectives itself. The flash and add+LN kernels are ``torch.library``
  ops with no DTensor sharding rules, and the wire and the checkpoints need
  full tensors under the JAX names, which ``sharding.gather_tensor``
  assembles.
- **Gradients.** The collectives are ``torch.autograd.Function`` s with
  JAX's transposes: ``psum`` sums forward and passes the gradient through
  (its output is replicated), ``copy_to`` is the identity forward and sums
  the gradient (the Megatron pair); ``all_gather`` keeps this rank's slice
  of the gradient; ``ppermute`` sends the gradient back the reverse hop.
  A loss built with ``psum`` is the slice's global loss on every rank, and
  each rank's backward gives the part of its gradient that comes from its
  own rows, positions or stages: a parameter's gradient is the ``psum`` of
  those parts over the batch axes (``BATCH_AXES``). Leaves replicated over
  the ``model`` and ``expert`` axes carry their full gradient on every rank
  of those axes, as in Megatron.
"""
from __future__ import annotations

import itertools
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

Axes = Union[str, Sequence[str]]

#: The axes a batch is split over: a parameter's gradient sums over them.
BATCH_AXES = ("data", "seq", "pipe")

LAUNCH = ("python -m torch.distributed.run --nproc_per_node {n} "
          "-m dedloc_tpu_torch.roles.trainer --training.mesh_devices {n} ...")


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: per dimension, the mesh axis it is
    split over, or None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Staging:
    """Bytes a gloo collective copied between the card and the host."""

    def __init__(self):
        self.bytes = 0


STAGING = Staging()


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class MeshLayout:
    """Axis names and sizes and the rank <-> coordinates map (row-major),
    with no process group: what the mesh's shape alone decides."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int]):
        if len(axis_names) != len(shape):
            raise ValueError(f"{len(axis_names)} axis names for a "
                             f"{len(shape)}-D shape {tuple(shape)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = int(np.prod(list(self.shape.values()), dtype=np.int64))

    def coords(self, rank: int) -> Dict[str, int]:
        idx = np.unravel_index(rank, tuple(self.shape.values()))
        return dict(zip(self.axis_names, (int(i) for i in idx)))

    def rank_of(self, coords: Dict[str, int]) -> int:
        return int(np.ravel_multi_index(
            tuple(coords[a] for a in self.axis_names),
            tuple(self.shape.values())))

    def axis_size(self, axes: Axes) -> int:
        return int(np.prod([self.shape[a] for a in _axes(axes)
                            if a in self.shape], dtype=np.int64))

    def group_ranks(self, axes: Axes, rank: int) -> List[int]:
        """The ranks that differ from ``rank`` only along ``axes``, ordered
        row-major over ``axes`` (in the mesh's axis order)."""
        axes = [a for a in self.axis_names if a in _axes(axes)]
        base = self.coords(rank)
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(base)
            c.update(zip(axes, idx))
            out.append(self.rank_of(c))
        return out

    def all_groups(self, axes: Axes) -> List[List[int]]:
        seen, out = set(), []
        for r in range(self.size):
            g = tuple(self.group_ranks(axes, r))
            if g not in seen:
                seen.add(g)
                out.append(list(g))
        return out


def placement(n_devices: int, device_offset: int, device_type: str,
              available: int) -> Tuple[List[torch.device], str]:
    """(device of each rank, backend) for ``n_devices`` ranks. Raises as
    JAX's ``make_mesh`` does when the offset leaves no device."""
    if n_devices <= 0 or device_offset < 0 or device_offset >= available:
        raise ValueError(
            f"device_offset {device_offset} + n_devices {n_devices} exceeds "
            f"the {available} available devices (or is non-positive)")
    if device_type == "cpu":
        return [torch.device("cpu")] * n_devices, "gloo"
    cards = available - device_offset
    devices = [torch.device(device_type, device_offset + r % cards)
               for r in range(n_devices)]
    return devices, ("nccl" if cards >= n_devices else "gloo")


def _available(device_type: str) -> int:
    return torch.cuda.device_count() if device_type == "cuda" else 1


def init_slice(n_devices: int, device_type: str, device_offset: int = 0,
               init_method: Optional[str] = None) -> torch.device:
    """Join this process to the slice's process group, as rank ``RANK`` of
    ``WORLD_SIZE`` (torchrun's environment), on the device and backend
    ``placement`` gives; returns the device. ``init_method`` defaults to
    ``DEDLOC_DIST_INIT`` or torchrun's ``env://``."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if world != n_devices:
        raise ValueError(
            f"a slice of mesh_devices={n_devices} runs as {n_devices} ranks, "
            f"one per mesh device; this process is one of {world}. Launch "
            f"it as: {LAUNCH.format(n=n_devices)}")
    devices, backend = placement(n_devices, device_offset, device_type,
                                 _available(device_type))
    device = devices[int(os.environ.get("LOCAL_RANK", rank))]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend,
            init_method=init_method or os.environ.get("DEDLOC_DIST_INIT",
                                                      "env://"),
            rank=rank, world_size=world)
    sharing = sum(d == device for d in devices)
    logger.info(f"slice rank {rank}/{world} on {device}, backend {backend}"
                f" ({sharing} rank(s) on this device)")
    return device


class Mesh(MeshLayout):
    """The slice mesh as this rank sees it: the layout, this rank's
    coordinates, device and backend, and the process group of every subset
    of axes that holds this rank."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 rank: int, device: torch.device, backend: str,
                 ranks_per_device: int = 1):
        super().__init__(axis_names, shape)
        self.rank = rank
        self.device = device
        self.backend = backend
        self.ranks_per_device = ranks_per_device
        self.index = self.coords(rank)
        self._groups: Dict[Tuple[str, ...], Tuple[object, List[int]]] = {}
        # pinned host buffers that gloo collectives stage CUDA tensors in
        self._pinned: Dict[tuple, torch.Tensor] = {}
        if self.size == 1:
            return
        names = [a for a in self.axis_names if self.shape[a] > 1]
        for k in range(1, len(names) + 1):
            for subset in itertools.combinations(names, k):
                if self.axis_size(subset) == self.size:
                    mine = list(range(self.size))
                    self._groups[subset] = (dist.group.WORLD, mine)
                    continue
                for ranks in self.all_groups(subset):
                    g = dist.new_group(ranks)  # every rank makes every group
                    if rank in ranks:
                        self._groups[subset] = (g, ranks)

    def axis_index(self, axis: str) -> int:
        return self.index.get(axis, 0)

    def host_buffer(self, slot: str, like: torch.Tensor) -> torch.Tensor:
        """A pinned host tensor shaped like ``like``, one per slot, size and
        dtype, reused: a collective has finished with it when it returns."""
        key = (slot, like.numel(), like.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(like.numel(), dtype=like.dtype,
                                                  pin_memory=True)
        return buf.view(like.shape)

    def group(self, axes: Axes):
        """(process group, its ranks) over the axes of ``axes`` this mesh
        has with more than one device; None when that is none."""
        key = tuple(a for a in self.axis_names
                    if a in _axes(axes) and self.shape[a] > 1)
        return self._groups[key] if key else None

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None,
              device_offset: int = 0,
              device_type: Optional[str] = None) -> Mesh:
    """The mesh of ``n_devices`` ranks (the whole process group by default)
    with ``axis_names`` over ``shape`` (all on the first axis by default).
    The process group must exist (``init_slice``) unless n_devices is 1.
    ``device_type`` defaults to the card (raising without one, as every
    entry point of the port does)."""
    from dedloc_tpu_torch.utils.device import resolve_device

    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = world if n_devices is None else n_devices
    if device_type is None:
        device_type = resolve_device(None).type
    devices, backend = placement(n, device_offset, device_type,
                                 _available(device_type))
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices needs {n} ranks, one per device; this "
            f"process group has {world}. Launch as: {LAUNCH.format(n=n)}")
    if dist.is_initialized():
        backend = dist.get_backend()
    if shape is None:
        shape = [n] + [1] * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold {n} devices")
    device = devices[rank]
    return Mesh(axis_names, shape, rank, device, backend,
                ranks_per_device=sum(d == device for d in devices))


# ----------------------------------------------------------- placement


def shard_batch(mesh: Mesh, axis: str = "data") -> PartitionSpec:
    """The placement of a batch leaf: its leading dim split over ``axis``."""
    return P(axis)


def replicate(mesh: Mesh) -> PartitionSpec:
    return P()


def local_block(shape: Sequence[int], spec: Sequence, mesh: Mesh) -> Tuple[slice, ...]:
    """This rank's block of an array of ``shape`` placed by ``spec`` (each
    dim split evenly over the mesh axes named for it; a name the mesh lacks
    does not split)."""
    out = []
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = [a for a in _axes(entry) if a in mesh.shape] if entry else []
        n = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
        if size % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"evenly over {axes} ({n} devices)")
        i = 0
        for a in axes:  # row-major over the named axes
            i = i * mesh.shape[a] + mesh.axis_index(a)
        step = size // n
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def put_batch(batch, mesh: Mesh, axis: str = "data", seq_axis=None,
              seq_length=None) -> Dict[str, torch.Tensor]:
    """This rank's part of a host batch (a dict of numpy arrays, the
    slice's whole batch), as tensors on the mesh device: the rows of its
    ``axis`` shard and, with ``seq_axis``, for leaves whose second dim is
    ``seq_length``, the columns of its sequence shard. Every rank draws the
    slice's whole batch, so a slice consumes the sample stream a JAX slice
    does."""
    out = {}
    for k, x in batch.items():
        x = np.asarray(x)
        spec = (P(axis, seq_axis) if seq_axis is not None and x.ndim >= 2
                and seq_length and x.shape[1] == seq_length
                else shard_batch(mesh, axis))
        out[k] = torch.as_tensor(
            np.ascontiguousarray(x[local_block(x.shape, spec, mesh)])
        ).to(mesh.device)
    return out


# ----------------------------------------------------------- collectives


def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.device.type == "cuda"


def _to_wire(mesh: Mesh, t: torch.Tensor, slot: str = "send") -> torch.Tensor:
    """A contiguous copy the backend can take: on a gloo group, a CUDA
    tensor goes to a pinned host buffer (counted)."""
    if _staged(mesh, t):
        STAGING.bytes += t.numel() * t.element_size()
        return mesh.host_buffer(slot, t).copy_(t.detach())
    return t.detach().contiguous().clone()


def _from_wire(mesh: Mesh, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if _staged(mesh, like):
        STAGING.bytes += t.numel() * t.element_size()
        return t.to(like.device)
    return t


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """16-bit floats as their bytes for the collectives that only move
    data: the transfer is exact whatever dtypes the backend supports."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.uint8)
    return t


def all_reduce(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """The sum of ``x`` over ``axes`` (a new tensor; x unchanged). Low
    precision floats are summed in fp32 and rounded once."""
    g = mesh.group(axes)
    if g is None:
        return x.clone()
    wide = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    buf = _to_wire(mesh, wide)
    dist.all_reduce(buf, group=g[0])
    return _from_wire(mesh, buf, x).to(x.dtype)


def all_gather(x: torch.Tensor, mesh: Mesh, axes: Axes, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` over ``axes`` concatenated along ``dim`` in the
    axes' row-major order."""
    g = mesh.group(axes)
    if g is None:
        return x.clone()
    buf = _to_wire(mesh, x)
    parts = [torch.empty_like(buf) for _ in g[1]]
    dist.all_gather([_as_bytes(p) for p in parts], _as_bytes(buf), group=g[0])
    return _from_wire(mesh, torch.cat(parts, dim=dim), x)


def broadcast(x: torch.Tensor, mesh: Mesh, axes: Axes, src_index: int = 0) -> torch.Tensor:
    """``x`` of the rank at position ``src_index`` of the group over
    ``axes``, on every rank of it."""
    g = mesh.group(axes)
    if g is None:
        return x
    buf = _to_wire(mesh, x)
    dist.broadcast(_as_bytes(buf), src=g[1][src_index], group=g[0])
    return _from_wire(mesh, buf, x)


def ppermute_raw(x: torch.Tensor, mesh: Mesh, axis: str,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: the rank at axis position i sends ``x`` to position
    j for each (i, j) in ``perm``; a rank no pair sends to gets zeros."""
    g = mesh.group(axis)
    if g is None:
        return x.clone() if any(i == j for i, j in perm) else torch.zeros_like(x)
    ranks, me = g[1], mesh.axis_index(axis)
    dst = [j for i, j in perm if i == me]
    src = [i for i, j in perm if j == me]
    buf = _to_wire(mesh, x)
    out = (mesh.host_buffer("recv", x).zero_() if _staged(mesh, x)
           else torch.zeros_like(buf))
    reqs = []
    if src:
        reqs.append(dist.irecv(_as_bytes(out), src=ranks[src[0]], group=g[0]))
    if dst:
        reqs.append(dist.isend(_as_bytes(buf), dst=ranks[dst[0]], group=g[0]))
    for r in reqs:
        r.wait()
    return _from_wire(mesh, out, x)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim, ctx.n = mesh, axes, dim, x.shape[dim]
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        axes = [a for a in ctx.mesh.axis_names if a in _axes(ctx.axes)]
        i = 0
        for a in axes:
            i = i * ctx.mesh.shape[a] + ctx.mesh.axis_index(a)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return ppermute_raw(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        back = [(j, i) for i, j in ctx.perm]
        return ppermute_raw(g.contiguous(), ctx.mesh, ctx.axis, back), None, None, None


def psum(x: torch.Tensor, mesh: Optional[Mesh], axes: Axes) -> torch.Tensor:
    """Sum over ``axes``; the gradient passes through (the output is
    replicated over them)."""
    if mesh is None or mesh.group(axes) is None:
        return x
    return _PSum.apply(x, mesh, axes)


def pmean(x: torch.Tensor, mesh: Optional[Mesh], axes: Axes) -> torch.Tensor:
    if mesh is None or mesh.group(axes) is None:
        return x
    from dedloc_tpu_torch.utils.device import divide

    return divide(psum(x, mesh, axes), mesh.axis_size(axes))


def copy_to(x: torch.Tensor, mesh: Optional[Mesh], axes: Axes) -> torch.Tensor:
    """Identity forward, the gradient summed over ``axes``: where a
    replicated value enters computations that differ across ``axes``."""
    if mesh is None or mesh.group(axes) is None:
        return x
    return _CopyTo.apply(x, mesh, axes)


def gather(x: torch.Tensor, mesh: Optional[Mesh], axes: Axes, dim: int = 0) -> torch.Tensor:
    """All-gather along ``dim``; the gradient keeps this rank's slice."""
    if mesh is None or mesh.group(axes) is None:
        return x
    return _AllGather.apply(x, mesh, axes, dim)


def ppermute(x: torch.Tensor, mesh: Optional[Mesh], axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute`` with its transpose: the gradient travels the
    reverse hop."""
    if mesh is None:
        return x
    return _PPermute.apply(x, mesh, axis, tuple(tuple(p) for p in perm))


def all_finite(tensors, mesh: Optional[Mesh]) -> torch.Tensor:
    """One bool, the same on every rank of the mesh: every element of every
    rank's ``tensors`` is finite."""
    flags = [torch.isfinite(t).all() for t in tensors]
    ok = torch.stack(flags).all() if flags else torch.tensor(True)
    if mesh is None or mesh.size == 1:
        return ok
    bad = all_reduce((~ok).to(torch.int32).reshape(1), mesh, mesh.axis_names)
    return (bad == 0)[0]
