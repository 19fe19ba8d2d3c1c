"""Carry ALBERT weights between the JAX package's parameter names and the
port's modules.

The JAX side is a flat numpy dict keyed by the swarm's wire naming,
``jax.tree_util.keystr`` paths such as
``['albert']['encoder']['layer']['block']['attention']['query']['kernel']``
(the ``/``-joined flax path form is accepted too). The port's side is a
``state_dict``-style dict keyed by module path
(``albert.encoder.layer.block.attention.query.weight``). Leaf rules:

- ``kernel`` ``[in, out]`` <-> a ``Linear`` ``weight`` ``[out, in]`` (transposed);
- ``scale`` <-> a LayerNorm ``weight``; ``embedding`` <-> an ``Embedding``
  ``weight``; ``bias`` and ``mlm_bias`` keep their names.

``params_to_jax(params_from_jax(named))`` gives back the same names, shapes,
dtypes and values exactly.

The shared state a peer serves and loads is the flattened
``(params, opt_state)`` pair of the JAX trainer, named as
``collaborative/optimizer.py`` ``_tree_to_named`` names it: params under
``[0]``, then the optax chain of ``lamb`` under ``[1][i]`` (an optional
global-norm clip with no leaves, the LAMB moments ``.count``/``.mu``/``.nu``,
and the learning-rate schedule's ``.count`` when the rate is a schedule).
``state_to_jax`` and ``state_from_jax`` carry the port's ``(params,
LambState)`` to and from those names; ``grad_name`` gives a gradient the
name ``named_device_leaves`` gives it in the JAX package (no ``[0]``).
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


def torch_name(keys: Tuple[str, ...]) -> Tuple[str, bool]:
    """(module path, transpose?) for the JAX leaf at ``keys``."""
    *mods, leaf = keys
    if leaf == "kernel":
        return ".".join(mods + ["weight"]), True
    if leaf in ("scale", "embedding"):
        return ".".join(mods + ["weight"]), False
    return ".".join(keys), False


def jax_keys(name: str, ndim: int) -> Tuple[Tuple[str, ...], bool]:
    """(JAX keys, transpose?) for the port's parameter ``name``."""
    *mods, leaf = name.split(".")
    if leaf != "weight":
        return tuple(mods + [leaf]), False
    if ndim == 1:
        return tuple(mods + ["scale"]), False
    if mods and mods[-1].endswith("_embeddings"):
        return tuple(mods + ["embedding"]), False
    return tuple(mods + ["kernel"]), True


def params_from_jax(named: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX leaf dict -> the port's ``state_dict`` (CPU tensors)."""
    out = {}
    for name, arr in named.items():
        tname, transpose = torch_name(jax_path(name))
        a = np.asarray(arr)
        out[tname] = torch.from_numpy(np.array(a.T if transpose else a, order="C"))
    return out


def params_to_jax(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's parameters (``state_dict`` or ``named_parameters``) ->
    JAX leaf dict keyed by keystr (a copy, not a view of the tensors)."""
    out = {}
    for name, t in params.items():
        a = t.detach().cpu().numpy()
        keys, transpose = jax_keys(name, a.ndim)
        out[keystr(keys)] = np.array(a.T if transpose else a, order="C")
    return out


def grad_name(name: str, ndim: int) -> Tuple[str, bool]:
    """(JAX keystr name, transpose?) of the port's parameter or gradient
    ``name``: the wire name of that gradient leaf in the JAX package."""
    keys, transpose = jax_keys(name, ndim)
    return keystr(keys), transpose


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
        for name, t in tensors.items():
            jname, transpose = grad_name(name, t.ndim)
            t = t.detach()
            out[prefix + jname] = t.t() if transpose else t
    device = next(iter(params.values())).device
    counts = [(f"[1][{moments}].count", lamb_state.count)]
    if sched is not None:
        counts.append((f"[1][{sched}].count", lamb_state.schedule_count))
    for name, c in counts:
        c = c if isinstance(c, torch.Tensor) else torch.tensor(int(c))
        out[name] = c.to(device=device, dtype=torch.int32)
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
