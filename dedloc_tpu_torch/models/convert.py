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
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

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
