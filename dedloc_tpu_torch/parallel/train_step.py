"""Train-step builders: local accumulation vs global apply.

Port of ``dedloc_tpu/parallel/train_step.py``. The collaborative loop
splits one step into two phases with different cadences:

  accumulate — per micro-batch: forward/backward, fp32 gradients summed into
               a persistent accumulator, plus a micro-batch counter.
  apply      — once per global optimizer step: optimizer update + LR
               schedule by global step.

``make_local_train_step`` fuses both for the single-peer path. The
collaborative optimizer applies through ``make_guarded_apply_step`` (per
leaf, on a slice) or ``make_flat_apply_step`` (off a mesh: multi-tensor
passes over the leaves in the wire's order): both fold the all-finite
check and the rollback into the apply, so the verdict ``ok`` stays a
device bool and no step waits on the host.

A loss function here is ``loss_fn(params, batch, rng) -> (loss, metrics)``
where ``params`` maps parameter names to tensors (``roles.common.
build_loss_fn`` makes one). JAX's arrays are immutable; here the gradient
accumulator and the parameters are updated in place, which is what JAX's
buffer donation achieves, so the states passed in are the states returned.

On a slice mesh (``parallel/mesh.py``) each rank holds its blocks of the
parameters (``param_sharding``: tensor and expert parallel leaves) and of
the moments (``opt_state_sharding``: the same, plus ZeRO-1 over the data
axis). A rank's accumulator sums the part of each gradient that comes
from its own rows, positions or stages (the loss is the slice's global
mean, ``roles/common.py`` ``build_loss_fn``); ``reduce_grads`` sums those
parts over the batch axes, and the mesh applies take the reduced
gradients in the parameters' layout (``mesh_update``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from dedloc_tpu_torch.ops import multi_tensor as mt
from dedloc_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    PartitionSpec as P,
    all_finite,
    all_reduce,
    local_block,
)
from dedloc_tpu_torch.telemetry.steps import in_region, region
from dedloc_tpu_torch.utils.device import divide

LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclasses.dataclass
class TrainState:
    """Model + optimizer state keyed by the global collaboration step."""

    step: int
    params: Dict[str, torch.nn.Parameter]
    opt_state: Any

    @classmethod
    def create(cls, params: Mapping[str, torch.nn.Parameter], tx) -> "TrainState":
        params = dict(params)
        return cls(step=0, params=params, opt_state=tx.init(params))


@in_region("accumulate")
def zeros_like_grads(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}


def _grads(loss_fn: LossFn, params, batch, rng):
    with region("fwd"):
        loss, metrics = loss_fn(params, batch, rng)
    names = list(params)
    with region("bwd"):
        grads = torch.autograd.grad(loss, [params[n] for n in names])
    metrics = {k: v.detach() for k, v in metrics.items()}
    return dict(zip(names, grads)), metrics


def make_accumulate_step(loss_fn: LossFn) -> Callable:
    """(params, grad_acc, n_acc, batch, rng) -> (grad_acc', n_acc', metrics).

    ``grad_acc`` holds the running SUM of per-micro-batch mean gradients in
    fp32 (added to in place); ``n_acc`` counts micro-batches so the caller
    can normalize before averaging/apply.

    On a slice mesh the batch is this rank's part (``mesh.put_batch``), the
    collectives are in ``loss_fn``'s model and loss (so the JAX step's mesh
    arguments have nothing to do here), and the sum is of this rank's parts
    of the gradients: ``reduce_grads`` completes it."""

    def step(params, grad_acc, n_acc: int, batch, rng: Optional[torch.Generator] = None):
        grads, metrics = _grads(loss_fn, params, batch, rng)
        with torch.no_grad(), region("accumulate"):
            for n, g in grads.items():
                grad_acc[n].add_(g.float())
        return grad_acc, n_acc + 1, metrics

    return step


def _flat_all_reduce(grads: Dict[str, torch.Tensor], names, mesh, axes) -> None:
    """``grads[n]`` for ``n`` in ``names`` summed over ``axes`` in place of
    the dict's entries: one all-reduce of one flat fp32 buffer."""
    flat = all_reduce(torch.cat([grads[n].float().reshape(-1) for n in names]),
                      mesh, axes)
    offset = 0
    for n in names:
        size = grads[n].numel()
        grads[n] = flat[offset:offset + size].view(grads[n].shape)
        offset += size


@torch.no_grad()
def reduce_grads(grads: Mapping[str, torch.Tensor], mesh,
                 param_sharding=None) -> Dict[str, torch.Tensor]:
    """Each rank's parts of the gradients summed over the batch axes (data,
    seq, pipe); a new dict. A leaf replicated over the ``model`` or
    ``expert`` axis is computed alike on its ranks there, but a kernel
    that sums in an order of its own (an atomic add) may round otherwise
    on each: with ``param_sharding`` (the specs, JAX layout) those leaves
    take their mean over the axis, so every rank applies the same bits."""
    out = {n: g.float().clone() for n, g in grads.items()}
    if mesh is None:
        return out
    if mesh.group(BATCH_AXES) is not None:
        _flat_all_reduce(out, list(out), mesh, BATCH_AXES)
    if param_sharding is not None:
        for axis in ("model", "expert"):
            if mesh.group(axis) is None:
                continue
            names = [n for n in out if axis not in param_sharding.get(n, ())]
            if names:
                _flat_all_reduce(out, names, mesh, axis)
                for n in names:
                    out[n] = divide(out[n], mesh.shape[axis])
    return out


def _leaf_axes(spec) -> Tuple[str, ...]:
    return tuple(a for a in spec if a is not None)


def mesh_update(tx, grads, opt_state, params, mesh, param_sharding=None,
                opt_state_sharding=None):
    """One optimizer update on this rank's blocks, out of place: (new
    params in the parameters' layout, new optimizer state). LAMB takes
    every layout below; another optimizer (LARS: the JAX SwAV mesh, whose
    state replicates) takes replicated leaves only.

    ``grads`` and ``params`` are this rank's parameter blocks (reduced
    gradients); ``param_sharding``/``opt_state_sharding`` their specs
    (JAX layout; None: replicated parameters, moments as the parameters).
    Under ZeRO each rank updates its moment block, on the matching block
    of the gradient and parameter; the clip and the trust ratio sum the
    partial squared norms over each leaf's axes, and the new parameter
    blocks are all-gathered back over the ZeRO axis. Every rank of a
    leaf's group computes the same values, so replicated leaves and the
    optimizer state stay bitwise equal across the slice."""
    from dedloc_tpu_torch.optim.lamb import LambState
    from dedloc_tpu_torch.parallel.sharding import gather_tensor, port_spec
    from dedloc_tpu_torch.parallel.zero import zero_part

    lamb = isinstance(opt_state, LambState)
    pspecs = param_sharding or {}
    mspecs = (opt_state_sharding.mu if lamb and opt_state_sharding is not None
              else pspecs)
    if not lamb:
        fields = ([f for f in opt_state_sharding if isinstance(f, dict)]
                  if opt_state_sharding is not None else [])
        split = sorted({a for specs in [pspecs] + fields
                        for spec in specs.values() for a in spec if a is not None})
        if split:
            raise NotImplementedError(
                f"{type(tx).__name__} on a mesh updates replicated leaves only "
                f"(the JAX SwAV mesh's layout); ZeRO and tensor or expert "
                f"parallel leaves (split over {split}) are LAMB's")
        updates, new_opt = tx.update(grads, opt_state, params)
        return {n: p + updates[n] for n, p in params.items()}, new_opt
    zparts, axes = {}, {}
    for n, p in params.items():
        m = mspecs.get(n, P())
        zparts[n] = zero_part(n, p.ndim, m, pspecs.get(n, P()))
        axes[n] = _leaf_axes(port_spec(n, p.ndim, m))
    blocks = {n: local_block(p.shape, zparts[n], mesh) for n, p in params.items()}
    g_z = {n: g[blocks[n]] for n, g in grads.items()}
    w_z = {n: p[blocks[n]] for n, p in params.items()}

    def reduce(name, sq):
        return all_reduce(sq, mesh, axes[name]) if axes[name] else sq

    updates, new_opt = tx.update(g_z, opt_state, w_z, reduce=reduce)
    new_params = {}
    for n, w in w_z.items():
        new = w + updates[n]
        new_params[n] = (gather_tensor(new, zparts[n], mesh)
                         if _leaf_axes(zparts[n]) else new)
    return new_params, new_opt


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def make_apply_step(tx, mesh=None, opt_state_sharding=None,
                    param_sharding=None) -> Callable:
    """(state, mean_grads) -> state'. Runs once per global step; the
    parameters are updated in place (``p + u`` in the parameter dtype).
    On a mesh: ``mesh_update`` on this rank's blocks."""
    if _sharded(mesh):
        @in_region("opt_apply")
        @torch.no_grad()
        def mesh_apply(state: TrainState, grads) -> TrainState:
            new_params, new_opt = mesh_update(
                tx, grads, state.opt_state, state.params, mesh,
                param_sharding, opt_state_sharding)
            for n, p in state.params.items():
                p.copy_(new_params[n])
            return TrainState(step=state.step + 1, params=state.params,
                              opt_state=new_opt)

        return mesh_apply

    @in_region("opt_apply")
    def apply(state: TrainState, grads) -> TrainState:
        updates, new_opt_state = tx.update(grads, state.opt_state, state.params)
        with torch.no_grad():
            for n, p in state.params.items():
                p.add_(updates[n])
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=new_opt_state)

    return apply


@in_region("accumulate")
@torch.no_grad()
def add_micro_grads(grad_acc: Dict[str, torch.Tensor], grads,
                    grad_accum_steps: int) -> None:
    """``grad_acc += g / grad_accum_steps`` per leaf in fp32: the JAX scan's
    division, which ``divide`` keeps IEEE on CUDA (x / 3 != x * (1 / 3))."""
    for n, g in grads.items():
        grad_acc[n].add_(divide(g.float(), grad_accum_steps))


def make_local_train_step(loss_fn: LossFn, tx, grad_accum_steps: int = 1,
                          mesh=None, opt_state_sharding=None,
                          param_sharding=None) -> Callable:
    """Single-peer fused step: micro-batches, then the optimizer apply.

    Batch leaves have shape [grad_accum_steps, per_step_batch, ...]; each
    micro-batch adds ``g / grad_accum_steps`` to the fp32 accumulator. On
    a mesh the batch is this rank's part, the accumulator is reduced over
    the batch axes before the apply, and the apply is ``mesh_update``."""
    apply = make_apply_step(tx, mesh, opt_state_sharding, param_sharding)

    def train_step(state: TrainState, batch, rng: Optional[torch.Generator] = None):
        grad_acc = zeros_like_grads(state.params)
        per_micro = []
        for i in range(grad_accum_steps):
            micro = {k: v[i] for k, v in batch.items()}
            grads, metrics = _grads(loss_fn, state.params, micro, rng)
            add_micro_grads(grad_acc, grads, grad_accum_steps)
            per_micro.append(metrics)
        metrics = {k: torch.stack([m[k] for m in per_micro]).mean()
                   for k in per_micro[0]}
        if _sharded(mesh):
            grad_acc = reduce_grads(grad_acc, mesh, param_sharding)
        return apply(state, grad_acc), metrics

    return train_step


def _device_count(x, device: torch.device) -> torch.Tensor:
    """A step or optimizer count as a 0-d int32 tensor on ``device``: a
    rolled-back apply must leave it where it was without a host read."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.full((), int(x), dtype=torch.int32, device=device)


def _all_finite(tensors) -> torch.Tensor:
    """One device bool: every element of every tensor is finite."""
    flags = [torch.isfinite(t).all() for t in tensors]
    return torch.stack(flags).all() if flags else torch.tensor(True)


def _is_tensors(field) -> bool:
    """An optimizer-state field holding per-parameter tensors (moments,
    momentum); the other fields are counts."""
    return isinstance(field, dict)


def _with_device_counts(state: TrainState, device) -> TrainState:
    """``state`` with its step and every count of its optimizer state (a
    NamedTuple: ``LambState``, ``LarsState``) as 0-d device tensors."""
    opt = state.opt_state
    return TrainState(
        step=_device_count(state.step, device), params=state.params,
        opt_state=opt._replace(**{
            f: _device_count(v, device) for f, v in opt._asdict().items()
            if not _is_tensors(v)}),
    )


def _select(ok: torch.Tensor, new, old):
    """``torch.where(ok, new, old)`` over an optimizer state, field by
    field (per tensor for the tensor dicts)."""
    return old._replace(**{
        f: ({n: torch.where(ok, getattr(new, f)[n], prev[n]) for n in prev}
            if _is_tensors(prev) else torch.where(ok, getattr(new, f), prev))
        for f, prev in old._asdict().items()})


def make_guarded_apply_step(tx, mesh=None, opt_state_sharding=None,
                            param_sharding=None, post_apply=None) -> Callable:
    """``make_apply_step`` with the NaN guard folded in: (state,
    mean_grads) -> (state', ok).

    The update is computed out of place; ``post_apply`` (e.g. the SwAV
    prototype re-normalization: ``TrainState -> TrainState`` on the new,
    out-of-place params) runs on the new state, then one all-finite reduce
    over its params gives the device bool ``ok``, and ``torch.where(ok,
    new, old)`` selects what is kept: the params are written in place, the
    step, the counts and the optimizer's tensors of a rejected update come
    back bitwise unchanged. Generic over the optimizer's state (``Lamb``'s
    moments and counts, ``Lars``'s momentum and count). No full copy of the
    state is taken and nothing waits on the host; the caller reads ``ok``
    later.

    On a mesh the update is ``mesh_update`` on this rank's blocks,
    ``post_apply`` runs on them, and ``ok`` is the verdict of the whole
    slice (every rank's new blocks finite), the same bool on every rank."""
    sharded = _sharded(mesh)

    @in_region("opt_apply")
    @torch.no_grad()
    def apply(state: TrainState, grads):
        device = next(iter(state.params.values())).device
        state = _with_device_counts(state, device)
        if sharded:
            new_params, new_opt = mesh_update(
                tx, grads, state.opt_state, state.params, mesh,
                param_sharding, opt_state_sharding)
        else:
            updates, new_opt = tx.update(grads, state.opt_state, state.params)
            new_params = {n: p + updates[n] for n, p in state.params.items()}
        new = TrainState(step=state.step + 1, params=new_params,
                         opt_state=new_opt)
        if post_apply is not None:
            new = post_apply(new)
        ok = (all_finite(new.params.values(), mesh) if sharded
              else _all_finite(new.params.values()))
        for n, p in state.params.items():
            p.copy_(torch.where(ok, new.params[n], p))
        step = torch.where(ok, new.step, state.step)
        return TrainState(step=step, params=state.params,
                          opt_state=_select(ok, new_opt, state.opt_state)), ok

    return apply


class FlatLayout:
    """Where each parameter sits in a wire-layout flat buffer: for each
    spec entry (sorted JAX names), the port's parameter name, its span and
    JAX shape, and the permutation from the port's layout to the JAX one
    (``models.convert``: a ``Linear`` weight ``[out, in]`` is a JAX kernel
    ``[in, out]``, a ``Conv2d`` weight OIHW a kernel HWIO; None where they
    agree)."""

    def __init__(self, spec, params: Mapping[str, torch.Tensor]):
        from dedloc_tpu_torch.models.convert import grad_name

        by_jax = {}
        for n, p in params.items():
            jname, perm = grad_name(n, p.ndim)
            by_jax[jname] = (n, perm)
        names = [name for name, _shape, _dtype in spec]
        if sorted(by_jax) != sorted(names):
            raise ValueError("flat apply spec does not match the parameter tree")
        self.entries: List[Tuple[str, int, int, Tuple[int, ...], Any]] = []
        offset = 0
        for name, shape, _dtype in spec:
            size = int(np.prod(shape)) if shape else 1
            tname, perm = by_jax[name]
            self.entries.append((tname, offset, size, tuple(shape), perm))
            offset += size
        self.names = [n for n, _o, _s, _shape, _perm in self.entries]

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The port's tensors as views of ``flat`` (in the port's layout),
        in spec order."""
        from dedloc_tpu_torch.models.convert import from_jax_layout

        return {n: from_jax_layout(flat[o:o + s].view(shape), perm)
                for n, o, s, shape, perm in self.entries}


def make_flat_apply_step(flat_tx, spec, post_apply=None,
                         from_tree: bool = False) -> Callable:
    """Flat apply: (state, flat_mean_grads) -> (state', ok).

    ``flat_tx`` is an ``optim.flat.FlatLamb`` or ``FlatLars`` and ``spec``
    the TreeLayout spec (sorted JAX names) that the flat gradient buffer
    follows: the averaging wire's spec. The update runs over the port's
    own leaves in spec order, as multi-tensor passes over one leaf table
    (``ops/multi_tensor.py``): ``flat_tx.candidate`` writes the candidate
    parameters into a buffer of their own, with ``post_apply``
    (``TrainState -> TrainState``) they go through it as views of that
    buffer, one all-finite reduce over its output gives ``ok``, and
    ``flat_tx.commit`` writes the optimizer's tensors and the parameters in
    place only where ``ok`` holds, reading it on the device: a rejected
    update leaves parameters, optimizer tensors, step and counts bitwise
    unchanged, and nothing waits on the host. The persistent state stays
    the per-leaf optimizer state (checkpoints, state sharing and wire names
    unchanged).

    The gradients are the flat buffer in the wire's (JAX) layout, whose
    leaves are taken in the port's layout once, or, with
    ``from_tree=True``, a dict keyed by parameter name (a solo step, the
    local-apply fallback, the benchmark's programs), read where it lies."""
    from dedloc_tpu_torch.optim.flat import FlatLamb, FlatLars

    if not isinstance(flat_tx, (FlatLamb, FlatLars)):
        raise TypeError(f"unsupported flat optimizer {type(flat_tx)!r}")
    layouts: Dict[Tuple[str, ...], FlatLayout] = {}
    table = flat_tx.table

    @in_region("opt_apply")
    @torch.no_grad()
    def apply(state: TrainState, grads):
        key = tuple(state.params)
        layout = layouts.get(key)
        if layout is None:
            layout = layouts[key] = FlatLayout(spec, state.params)
        names = layout.names
        device = next(iter(state.params.values())).device
        state = _with_device_counts(state, device)
        opt = state.opt_state
        if not from_tree:
            grads = layout.views(grads)
        g = [grads[n].float().contiguous() for n in names]
        p = [state.params[n] for n in names]
        tensors = [[getattr(opt, f)[n] for n in names] for f in flat_tx.fields]
        cand = table.empty_like(p)
        b = table.bind([g, p, *tensors, cand])
        ctx = flat_tx.candidate(b, opt)
        step = state.step + 1
        if post_apply is not None:
            new = post_apply(TrainState(step=step, params=dict(zip(names, cand)),
                                        opt_state=opt))
            b = b.rebind(len(b.roles) - 1, [new.params[n].contiguous() for n in names])
            step = new.step
        ok = mt.all_finite(b, len(b.roles) - 1)
        flat_tx.commit(b, ok, ctx)
        opt_state = opt._replace(
            schedule_count=torch.where(ok, opt.schedule_count + 1,
                                       opt.schedule_count),
            **{f: torch.where(ok, c, getattr(opt, f))
               for f, c in flat_tx.counts(opt).items()},
        )
        step = torch.where(ok, step, state.step)
        return TrainState(step=step, params=state.params, opt_state=opt_state), ok

    return apply
