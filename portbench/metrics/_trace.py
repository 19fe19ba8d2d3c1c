"""Arithmetic on the profiled stretch the metric readers share: device
operations by kind and the kernels of one name. Kinds follow a frozen
copy of the port's ``tools/profile_albert.py`` ``_kind``, widened so that
cuDNN's convolution kernels count as library work beside the matmuls."""
from __future__ import annotations

import re

LIBRARY = re.compile(r"gemm|xmma|cutlass|nvjet|sm90_|conv|fprop|dgrad|wgrad",
                     re.IGNORECASE)


def kind(event: dict) -> str:
    if event.get("cat") != "kernel":
        return "copy/memset"
    name = event["name"]
    if "flash_" in name or "_ln_" in name:
        return "port kernels"
    if LIBRARY.search(name):
        return "library"
    return "other"


def kernels(profile: dict, *names: str) -> list:
    """Kernel events whose name holds one of ``names``."""
    return [e for e in profile["events"]
            if e.get("cat") == "kernel" and any(n in e["name"] for n in names)]


def seconds(events) -> float:
    return sum(e["dur"] for e in events) * 1e-6
