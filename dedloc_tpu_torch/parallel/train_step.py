"""Train-step builders: local accumulation vs global apply, single device.

Port of ``dedloc_tpu/parallel/train_step.py`` (mesh and sharding arguments
wait for later slices). The collaborative loop splits one step into two
phases with different cadences:

  accumulate — per micro-batch: forward/backward, fp32 gradients summed into
               a persistent accumulator, plus a micro-batch counter.
  apply      — once per global optimizer step: optimizer update + LR
               schedule by global step.

``make_local_train_step`` fuses both for the single-peer path. The
collaborative optimizer applies through ``make_guarded_apply_step`` (per
leaf) or ``make_flat_apply_step`` (one flat buffer in the wire's layout):
both fold the all-finite check and the rollback into the apply, so the
verdict ``ok`` stays a device bool and no step waits on the host.

A loss function here is ``loss_fn(params, batch, rng) -> (loss, metrics)``
where ``params`` maps parameter names to tensors (``roles.common.
build_loss_fn`` makes one). JAX's arrays are immutable; here the gradient
accumulator and the parameters are updated in place, which is what JAX's
buffer donation achieves, so the states passed in are the states returned.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

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


def zeros_like_grads(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}


def _grads(loss_fn: LossFn, params, batch, rng):
    loss, metrics = loss_fn(params, batch, rng)
    names = list(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    metrics = {k: v.detach() for k, v in metrics.items()}
    return dict(zip(names, grads)), metrics


def make_accumulate_step(loss_fn: LossFn) -> Callable:
    """(params, grad_acc, n_acc, batch, rng) -> (grad_acc', n_acc', metrics).

    ``grad_acc`` holds the running SUM of per-micro-batch mean gradients in
    fp32 (added to in place); ``n_acc`` counts micro-batches so the caller
    can normalize before averaging/apply."""

    def step(params, grad_acc, n_acc: int, batch, rng: Optional[torch.Generator] = None):
        grads, metrics = _grads(loss_fn, params, batch, rng)
        with torch.no_grad():
            for n, g in grads.items():
                grad_acc[n].add_(g.float())
        return grad_acc, n_acc + 1, metrics

    return step


def make_apply_step(tx) -> Callable:
    """(state, mean_grads) -> state'. Runs once per global step; the
    parameters are updated in place (``p + u`` in the parameter dtype)."""

    def apply(state: TrainState, grads) -> TrainState:
        updates, new_opt_state = tx.update(grads, state.opt_state, state.params)
        with torch.no_grad():
            for n, p in state.params.items():
                p.add_(updates[n])
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=new_opt_state)

    return apply


def make_local_train_step(loss_fn: LossFn, tx, grad_accum_steps: int = 1) -> Callable:
    """Single-peer fused step: micro-batches, then the optimizer apply.

    Batch leaves have shape [grad_accum_steps, per_step_batch, ...]; each
    micro-batch adds ``g / grad_accum_steps`` to the fp32 accumulator."""
    apply = make_apply_step(tx)

    def train_step(state: TrainState, batch, rng: Optional[torch.Generator] = None):
        grad_acc = zeros_like_grads(state.params)
        per_micro = []
        for i in range(grad_accum_steps):
            micro = {k: v[i] for k, v in batch.items()}
            grads, metrics = _grads(loss_fn, state.params, micro, rng)
            with torch.no_grad():
                for n, g in grads.items():
                    grad_acc[n].add_(g.float() / grad_accum_steps)
            per_micro.append(metrics)
        metrics = {k: torch.stack([m[k] for m in per_micro]).mean()
                   for k in per_micro[0]}
        return apply(state, grad_acc), metrics

    return train_step


def _no_mesh(mesh, opt_state_sharding, param_sharding, post_apply) -> None:
    if mesh is not None or opt_state_sharding is not None or param_sharding is not None:
        raise NotImplementedError(
            "mesh, opt_state_sharding and param_sharding come with the "
            "parallel-axes slice (ROADMAP, queue A); the port applies on one "
            "device")
    if post_apply is not None:
        raise NotImplementedError("post_apply comes with the SwAV slice")


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


def _with_device_counts(state: TrainState, device) -> TrainState:
    opt = state.opt_state
    return TrainState(
        step=_device_count(state.step, device), params=state.params,
        opt_state=opt._replace(
            count=_device_count(opt.count, device),
            schedule_count=_device_count(opt.schedule_count, device)),
    )


def make_guarded_apply_step(tx, mesh=None, opt_state_sharding=None,
                            param_sharding=None, post_apply=None) -> Callable:
    """``make_apply_step`` with the NaN guard folded in: (state,
    mean_grads) -> (state', ok).

    The update is computed out of place; one all-finite reduce over the new
    params gives the device bool ``ok``, and ``torch.where(ok, new, old)``
    selects what is kept: the params are written in place, the step, the
    counts and the moments of a rejected update come back bitwise
    unchanged. No full copy of the state is taken and nothing waits on the
    host; the caller reads ``ok`` later."""
    _no_mesh(mesh, opt_state_sharding, param_sharding, post_apply)

    @torch.no_grad()
    def apply(state: TrainState, grads):
        device = next(iter(state.params.values())).device
        state = _with_device_counts(state, device)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        new_params = {n: p + updates[n] for n, p in state.params.items()}
        ok = _all_finite(new_params.values())
        for n, p in state.params.items():
            p.copy_(torch.where(ok, new_params[n], p))
        old = state.opt_state
        keep = lambda new, prev: {n: torch.where(ok, new[n], prev[n]) for n in prev}
        opt_state = old._replace(
            count=torch.where(ok, new_opt.count, old.count),
            mu=keep(new_opt.mu, old.mu), nu=keep(new_opt.nu, old.nu),
            schedule_count=torch.where(ok, new_opt.schedule_count,
                                       old.schedule_count),
        )
        step = torch.where(ok, state.step + 1, state.step)
        return TrainState(step=step, params=state.params, opt_state=opt_state), ok

    return apply


class FlatLayout:
    """Where each parameter sits in a wire-layout flat buffer: for each
    spec entry (sorted JAX names), the port's parameter name, its span and
    JAX shape, and whether the port stores it transposed (a ``Linear``
    weight is ``[out, in]``, a JAX kernel ``[in, out]``)."""

    def __init__(self, spec, params: Mapping[str, torch.Tensor]):
        from dedloc_tpu_torch.models.convert import grad_name

        by_jax = {}
        for n, p in params.items():
            jname, transpose = grad_name(n, p.ndim)
            by_jax[jname] = (n, transpose)
        names = [name for name, _shape, _dtype in spec]
        if sorted(by_jax) != sorted(names):
            raise ValueError("flat apply spec does not match the parameter tree")
        self.entries: List[Tuple[str, int, int, Tuple[int, ...], bool]] = []
        offset = 0
        for name, shape, _dtype in spec:
            size = int(np.prod(shape)) if shape else 1
            tname, transpose = by_jax[name]
            self.entries.append((tname, offset, size, tuple(shape), transpose))
            offset += size
        self.total = offset
        self.key = [(name, tuple(shape)) for name, shape, _dtype in spec]

    def flatten(self, tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """One fp32 buffer in spec order, in the JAX layout."""
        return torch.cat([
            (tensors[n].t() if t else tensors[n]).reshape(-1).to(torch.float32)
            for n, _o, _s, _shape, t in self.entries
        ])

    def unflatten_into(self, flat: torch.Tensor,
                       tensors: Mapping[str, torch.Tensor]) -> None:
        """Write ``flat`` back into ``tensors`` (in place), transposing
        where the port's layout differs."""
        for n, o, s, shape, t in self.entries:
            view = flat[o:o + s].view(shape)
            tensors[n].copy_(view.t() if t else view)


def make_flat_apply_step(flat_tx, spec, post_apply=None,
                         from_tree: bool = False) -> Callable:
    """Flat apply: (state, flat_mean_grads) -> (state', ok).

    ``flat_tx`` is an ``optim.flat.FlatLamb`` and ``spec`` the TreeLayout
    spec (sorted JAX names) that the flat gradient buffer follows: the
    averaging wire's spec, so the averaged result goes to the card as ONE
    buffer. Params and moments are flattened onto that layout (transposed
    where the port stores them transposed), the whole LAMB update runs as
    segment reductions over the flat buffer, one all-finite reduce over the
    new flat params gives ``ok``, and ``torch.where(ok, new, old)`` on the
    flat buffers selects what is written back. The persistent state stays
    the per-leaf ``LambState`` (checkpoints, state sharing and wire names
    unchanged).

    ``from_tree=True`` takes a dict of gradients keyed by parameter name
    (the solo path, where gradients were never flattened)."""
    from dedloc_tpu_torch.optim.flat import FlatLamb

    _no_mesh(None, None, None, post_apply)
    if not isinstance(flat_tx, FlatLamb):
        raise TypeError(f"unsupported flat optimizer {type(flat_tx)!r}")
    layouts: Dict[Tuple[str, ...], FlatLayout] = {}

    @torch.no_grad()
    def apply(state: TrainState, grads):
        key = tuple(state.params)
        layout = layouts.get(key)
        if layout is None:
            layout = layouts[key] = FlatLayout(spec, state.params)
        device = next(iter(state.params.values())).device
        state = _with_device_counts(state, device)
        opt = state.opt_state
        flat_grads = layout.flatten(grads) if from_tree else grads
        flat_params = layout.flatten(state.params)
        flat_mu, flat_nu = layout.flatten(opt.mu), layout.flatten(opt.nu)
        updates, new_mu, new_nu, new_count = flat_tx.update(
            flat_grads, flat_params, flat_mu, flat_nu, opt.count,
            opt.schedule_count)
        new_params = flat_params + updates
        ok = torch.isfinite(new_params).all()
        for new, old, dst in ((new_params, flat_params, state.params),
                              (new_mu, flat_mu, opt.mu),
                              (new_nu, flat_nu, opt.nu)):
            layout.unflatten_into(torch.where(ok, new, old), dst)
        opt_state = opt._replace(
            count=torch.where(ok, new_count, opt.count),
            schedule_count=torch.where(ok, opt.schedule_count + 1,
                                       opt.schedule_count),
        )
        step = torch.where(ok, state.step + 1, state.step)
        return TrainState(step=step, params=state.params, opt_state=opt_state), ok

    return apply
