"""Carry weights between the JAX package's parameter names and the port's
modules (ALBERT, and the SwAV ResNet with its prototypes head).

The JAX side is a flat numpy dict keyed by the swarm's wire naming,
``jax.tree_util.keystr`` paths such as
``['albert']['encoder']['layer']['block']['attention']['query']['kernel']``
(the ``/``-joined flax path form is accepted too). The port's side is a
``state_dict``-style dict keyed by module path
(``albert.encoder.layer.block.attention.query.weight``). Leaf rules:

- ``kernel`` ``[in, out]`` <-> a ``Linear`` ``weight`` ``[out, in]`` (transposed);
- a 4-D ``kernel`` HWIO <-> a ``Conv2d`` ``weight`` OIHW (permuted);
- ``scale`` <-> a LayerNorm or BatchNorm ``weight``; ``embedding`` <-> an
  ``Embedding`` ``weight``; ``bias``, ``mlm_bias`` and the batch statistics
  ``mean`` and ``var`` keep their names.

A leaf's layout is a permutation ``perm`` (``None`` where the layouts agree):
the JAX array is ``torch_tensor.permute(perm)`` (``to_jax_layout``), and the
port's tensor is the JAX array under the inverse permutation
(``from_jax_layout``).

``params_to_jax(params_from_jax(named))`` gives back the same names, shapes,
dtypes and values exactly.

On a slice mesh (``parallel/mesh.py``) a rank holds blocks of the sharded
leaves: ``params_from_jax_sharded`` cuts full JAX parameters straight to a
rank's blocks by the TP/EP rules (``parallel/sharding.py``),
``params_to_jax_gathered`` assembles the full JAX dict from every rank's
blocks (a collective), and ``shard_named`` / ``gather_named`` do the same
for any named JAX-layout arrays under specs in the JAX layout (the shared
state's parameters and moments).

The shared state a peer serves and loads is the flattened
``(params, opt_state)`` pair of the JAX trainer, named as
``collaborative/optimizer.py`` ``_tree_to_named`` names it: params under
``[0]``, then the optimizer's state under ``[1]``. For the optax chain of
``lamb``: ``[1][i]`` (an optional global-norm clip with no leaves, the LAMB
moments ``.count``/``.mu``/``.nu``, and the learning-rate schedule's
``.count`` when the rate is a schedule); for ``lars``: ``[1][0].momentum``
and ``[1][1].count``. ``state_to_jax`` and ``state_from_jax`` carry the
port's ``(params, LambState)`` to and from the LAMB names,
``lars_state_views`` and ``lars_state_from_jax`` the ``(params,
LarsState)`` pair; ``grad_name`` gives a gradient the name
``named_device_leaves`` gives it in the JAX package (no ``[0]``).
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_KEYSTR = re.compile(r"\['([^']*)'\]")


def jax_path(name: str) -> Tuple[str, ...]:
    """The keys of a JAX leaf name in keystr or ``/``-joined form."""
    if name.startswith("["):
        keys = tuple(_KEYSTR.findall(name))
        if keystr(keys) != name:
            raise ValueError(f"malformed keystr leaf name {name!r}")
        return keys
    return tuple(name.split("/"))


def keystr(keys) -> str:
    return "".join(f"['{k}']" for k in keys)


Perm = Optional[Tuple[int, ...]]

# torch layout -> JAX layout of a kernel, by rank: Linear [out, in] -> [in,
# out]; Conv2d OIHW -> HWIO
_KERNEL_PERM = {2: (1, 0), 4: (2, 3, 1, 0)}


def inverse_perm(perm: Perm) -> Perm:
    if perm is None:
        return None
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return tuple(inv)


def to_jax_layout(t: torch.Tensor, perm: Perm) -> torch.Tensor:
    """The port's tensor as a view in the JAX element order."""
    return t if perm is None else t.permute(perm)


def from_jax_layout(a, perm: Perm):
    """A JAX-layout array or tensor in the port's layout (a view)."""
    if perm is None:
        return a
    inv = inverse_perm(perm)
    return a.permute(inv) if isinstance(a, torch.Tensor) else np.transpose(a, inv)


def torch_name(keys: Tuple[str, ...], ndim: int) -> Tuple[str, Perm]:
    """(module path, perm) for the JAX leaf at ``keys`` of rank ``ndim``."""
    *mods, leaf = keys
    if leaf == "kernel":
        return ".".join(mods + ["weight"]), _KERNEL_PERM[ndim]
    if leaf in ("scale", "embedding"):
        return ".".join(mods + ["weight"]), None
    return ".".join(keys), None


def jax_keys(name: str, ndim: int) -> Tuple[Tuple[str, ...], Perm]:
    """(JAX keys, perm) for the port's parameter ``name`` of rank ``ndim``."""
    *mods, leaf = name.split(".")
    if leaf != "weight":
        return tuple(mods + [leaf]), None
    if ndim == 1:
        return tuple(mods + ["scale"]), None
    if mods and mods[-1].endswith("_embeddings"):
        return tuple(mods + ["embedding"]), None
    return tuple(mods + ["kernel"]), _KERNEL_PERM[ndim]


def params_from_jax(named: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX leaf dict -> the port's ``state_dict`` (CPU tensors)."""
    out = {}
    for name, arr in named.items():
        a = np.asarray(arr)
        tname, perm = torch_name(jax_path(name), a.ndim)
        out[tname] = torch.from_numpy(np.array(from_jax_layout(a, perm), order="C"))
    return out


def params_from_checkpoint(named: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The params of a checkpoint tree -> the port's ``state_dict`` (CPU
    tensors). The tree is either a trainer's ``(params, opt_state)`` pair
    (params under ``[0]``; the optimizer's leaves are left out) or bare
    params."""
    params = {k[3:]: v for k, v in named.items() if k.startswith("[0]")}
    return params_from_jax(params or named)


def params_to_jax(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's parameters (``state_dict`` or ``named_parameters``) ->
    JAX leaf dict keyed by keystr (a copy, not a view of the tensors)."""
    out = {}
    for name, t in params.items():
        keys, perm = jax_keys(name, t.ndim)
        a = to_jax_layout(t.detach(), perm).cpu().numpy()
        out[keystr(keys)] = np.array(a, order="C")
    return out


def grad_name(name: str, ndim: int) -> Tuple[str, Perm]:
    """(JAX keystr name, perm) of the port's parameter or gradient
    ``name``: the wire name of that gradient leaf in the JAX package."""
    keys, perm = jax_keys(name, ndim)
    return keystr(keys), perm


def _named_views(prefix: str, tensors: Mapping[str, torch.Tensor],
                 out: Dict[str, torch.Tensor]) -> None:
    """``out[prefix + JAX name] =`` each tensor as a view in the JAX element
    order (nothing is copied)."""
    for name, t in tensors.items():
        jname, perm = grad_name(name, t.ndim)
        out[prefix + jname] = to_jax_layout(t.detach(), perm)


def _count(c, device) -> torch.Tensor:
    c = c if isinstance(c, torch.Tensor) else torch.tensor(int(c))
    return c.to(device=device, dtype=torch.int32)


def lamb_chain_slots(clip: bool, schedule: bool) -> Tuple[int, Optional[int]]:
    """Positions in the JAX ``lamb`` chain of the moments' state and of the
    schedule's count (None without a schedule): a global-norm clip comes
    first and holds no leaves."""
    moments = 1 if clip else 0
    return moments, (moments + 1 if schedule else None)


def state_views(params: Mapping[str, torch.Tensor], lamb_state, clip: bool,
                schedule: bool) -> Dict[str, torch.Tensor]:
    """The port's ``(params, LambState)`` under the JAX trainer's
    shared-state names, as views in the JAX element order (a kernel is the
    transposed view of its ``Linear`` weight; nothing is copied) on the
    tensors' device; counts as 0-d int32 tensors. ``clip``/``schedule``:
    whether the chain has a global-norm clip and a learning-rate schedule
    (``Lamb.max_grad_norm``, ``Lamb.has_schedule``)."""
    moments, sched = lamb_chain_slots(clip, schedule)
    out: Dict[str, torch.Tensor] = {}
    for prefix, tensors in (("[0]", params),
                            (f"[1][{moments}].mu", lamb_state.mu),
                            (f"[1][{moments}].nu", lamb_state.nu)):
        _named_views(prefix, tensors, out)
    device = next(iter(params.values())).device
    out[f"[1][{moments}].count"] = _count(lamb_state.count, device)
    if sched is not None:
        out[f"[1][{sched}].count"] = _count(lamb_state.schedule_count, device)
    return out


def state_to_jax(params: Mapping[str, torch.Tensor], lamb_state,
                 clip: bool, schedule: bool) -> Dict[str, np.ndarray]:
    """``state_views`` as host arrays (C-order copies, never views of the
    tensors)."""
    return {k: np.array(v.cpu().numpy(), order="C")
            for k, v in state_views(params, lamb_state, clip, schedule).items()}


_SLOT = re.compile(r"^\[1\]\[(\d+)\]\.(count|mu|nu)(.*)$")


def state_from_jax(named: Mapping[str, np.ndarray]):
    """The JAX trainer's shared state -> ``(params, LambState)`` on the CPU
    (counts as ints; a chain without a schedule gives schedule count 0).
    Raises ``KeyError``/``ValueError`` on names that are not a ``lamb``
    chain's."""
    from dedloc_tpu_torch.optim.lamb import LambState

    params, moments = {}, {"mu": {}, "nu": {}}
    counts: Dict[int, int] = {}
    slot_of_moments = None
    for name, arr in named.items():
        if name.startswith("[0]"):
            params[name[3:]] = arr
            continue
        m = _SLOT.match(name)
        if m is None:
            raise KeyError(f"not a lamb-chain state name: {name!r}")
        slot, field, rest = int(m.group(1)), m.group(2), m.group(3)
        if field == "count":
            if rest:
                raise KeyError(f"malformed count name {name!r}")
            counts[slot] = int(np.asarray(arr))
        else:
            if slot_of_moments not in (None, slot):
                raise ValueError(f"moments in two chain slots: {name!r}")
            slot_of_moments = slot
            moments[field][rest] = arr
    if slot_of_moments is None or slot_of_moments not in counts:
        raise KeyError("no lamb moments in the state")
    extra = set(counts) - {slot_of_moments, slot_of_moments + 1}
    if extra:
        raise KeyError(f"unexpected chain slots {sorted(extra)}")
    state = LambState(
        count=counts[slot_of_moments],
        mu=params_from_jax(moments["mu"]),
        nu=params_from_jax(moments["nu"]),
        schedule_count=counts.get(slot_of_moments + 1, 0),
    )
    return params_from_jax(params), state


def lars_state_views(params: Mapping[str, torch.Tensor],
                     lars_state) -> Dict[str, torch.Tensor]:
    """The port's ``(params, LarsState)`` under the JAX SwAV peer's
    shared-state names (``lars`` returns the pair ``(LarsState(momentum),
    ScaleByScheduleState(count))``): ``[0]`` params, ``[1][0].momentum``
    and ``[1][1].count``, as views in the JAX element order."""
    out: Dict[str, torch.Tensor] = {}
    _named_views("[0]", params, out)
    _named_views("[1][0].momentum", lars_state.momentum, out)
    device = next(iter(params.values())).device
    out["[1][1].count"] = _count(lars_state.schedule_count, device)
    return out


def lars_state_from_jax(named: Mapping[str, np.ndarray]):
    """The JAX SwAV peer's shared state -> ``(params, LarsState)`` on the
    CPU (the count as an int). Raises ``KeyError`` on names that are not a
    ``lars`` state's."""
    from dedloc_tpu_torch.optim.lars import LarsState

    params, momentum, count = {}, {}, None
    for name, arr in named.items():
        if name.startswith("[0]"):
            params[name[3:]] = arr
        elif name.startswith("[1][0].momentum"):
            momentum[name[len("[1][0].momentum"):]] = arr
        elif name == "[1][1].count":
            count = int(np.asarray(arr))
        else:
            raise KeyError(f"not a lars state name: {name!r}")
    if count is None:
        raise KeyError("no lars schedule count in the state")
    return params_from_jax(params), LarsState(
        momentum=params_from_jax(momentum), schedule_count=count)


# ------------------------------------------------------------ slice shards


def shard_named(named: Mapping[str, np.ndarray], specs: Mapping, mesh) -> Dict[str, np.ndarray]:
    """This rank's block of each JAX-layout array (specs in the JAX layout;
    a name without one is replicated)."""
    from dedloc_tpu_torch.parallel.mesh import local_block

    out = {}
    for name, arr in named.items():
        a = np.asarray(arr)
        spec = specs.get(name, ())
        out[name] = np.ascontiguousarray(a[local_block(a.shape, spec, mesh)]) if spec else a
    return out


def gather_named(named: Mapping[str, torch.Tensor], specs: Mapping, mesh) -> Dict[str, torch.Tensor]:
    """The full JAX-layout tensors from every rank's blocks (an all-gather
    along each split dim; every rank of the mesh calls it, names in the
    same order)."""
    from dedloc_tpu_torch.parallel.sharding import gather_tensor

    return {name: gather_tensor(t, specs.get(name, ()), mesh)
            for name, t in named.items()}


def params_from_jax_sharded(named: Mapping[str, np.ndarray], mesh, rules) -> Dict[str, torch.Tensor]:
    """Full JAX parameters -> this rank's blocks of the port's
    ``state_dict`` (CPU tensors), cut by ``rules``."""
    from dedloc_tpu_torch.parallel.sharding import spec_for_path

    specs = {name: spec_for_path(keystr(jax_path(name)), rules) for name in named}
    return params_from_jax(shard_named(named, specs, mesh))


def params_to_jax_gathered(params: Mapping[str, torch.Tensor], mesh, rules) -> Dict[str, np.ndarray]:
    """This rank's blocks of the port's parameters (or of tensors shaped
    like them, e.g. gradients) -> the full JAX leaf dict; a collective."""
    from dedloc_tpu_torch.parallel.sharding import spec_for_path

    views, specs = {}, {}
    for name, t in params.items():
        keys, perm = jax_keys(name, t.ndim)
        views[keystr(keys)] = to_jax_layout(t.detach(), perm).contiguous()
        specs[keystr(keys)] = spec_for_path(keystr(keys), rules)
    return {k: np.array(v.cpu().numpy(), order="C")
            for k, v in gather_named(views, specs, mesh).items()}
