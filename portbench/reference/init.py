"""The benchmark's weights: every leaf of a parameter list drawn from a
seed on the device, in a few large calls, in float32.

A spec is a list of ``(name, shape, kind, scale)``: ``normal`` draws
N(0, scale^2), ``trunc`` a normal of standard deviation ``scale``
truncated at two of them (flax's lecun-normal kernels), ``zeros`` and
``ones`` fill. All normal leaves come from one draw, all truncated leaves
from another, each then scaled leaf by leaf in one multiply. The same
seed gives the same tensors on a device of the same kind; both the program
and the plain reference take them from here.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], str, float]]


def generator(seed: int, device, offset: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` (any whole number;
    ``offset`` separates the streams that one seed feeds)."""
    return torch.Generator(device=device).manual_seed((seed + offset) % 2 ** 63)


def _drawn(leaves: Sequence[Tuple[str, Tuple[int, ...], float]], g, device,
           truncated: bool) -> Dict[str, torch.Tensor]:
    if not leaves:
        return {}
    sizes = [int(torch.Size(shape).numel()) for _n, shape, _s in leaves]
    flat = torch.empty(sum(sizes), device=device)
    if truncated:
        torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=g)
    else:
        flat.normal_(0.0, 1.0, generator=g)
    scale = torch.repeat_interleave(
        torch.tensor([s for _n, _shape, s in leaves], device=device),
        torch.tensor(sizes, device=device), output_size=flat.numel())
    flat.mul_(scale)
    out, offset = {}, 0
    for (name, shape, _s), size in zip(leaves, sizes):
        out[name] = flat[offset:offset + size].view(shape)
        offset += size
    return out


def draw(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{name: float32 tensor on device}`` for every leaf of ``spec``."""
    g = generator(seed, device)
    out = {}
    out.update(_drawn([(n, s, c) for n, s, k, c in spec if k == "normal"], g,
                      device, truncated=False))
    out.update(_drawn([(n, s, c) for n, s, k, c in spec if k == "trunc"], g,
                      device, truncated=True))
    for name, shape, kind, _scale in spec:
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind not in ("normal", "trunc"):
            raise ValueError(f"{name}: unknown init kind {kind!r}")
    return {name: out[name] for name, *_ in spec}
