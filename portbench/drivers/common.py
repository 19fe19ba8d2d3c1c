"""What the drivers share: the benchmark's spans around the program's
calls, and the readings a program's first steps give."""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import torch

from portbench.reference.train import to_host


class Spans:
    """Host-clock spans the benchmark records around its calls into the
    program: ``data`` (the batch's move to the device, no wait) and
    ``boundary`` (from the last micro-batch's end to the apply's end, the
    device synchronised on both sides). Off, they cost nothing and wait for
    nothing. ``labels`` also names each span for the profiler."""

    def __init__(self, on: bool = False, sync: Callable[[], None] = lambda: None,
                 labels: bool = False):
        self.on, self.sync, self.labels = on, sync, labels
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def _span(self, name: str, wait: bool):
        if not (self.on or self.labels):
            yield
            return
        label = (torch.profiler.record_function(f"portbench.{name}") if self.labels
                 else contextlib.nullcontext())
        if wait:
            self.sync()
        t0 = time.perf_counter()
        with label:
            yield
            if wait:
                self.sync()
        if self.on:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0
            self.counts[name] = self.counts.get(name, 0) + 1

    def data(self):
        return self._span("data", wait=False)

    def boundary(self):
        return self._span("boundary", wait=True)

    def compute(self):
        """A label for the profiler around the forward and backward."""
        return (torch.profiler.record_function("portbench.fwd_bwd") if self.labels
                else contextlib.nullcontext())


OFF = Spans()


def changes(now: Dict[str, torch.Tensor], then: Dict[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
    """Each leaf's change from ``then``, as float32 on the host."""
    return to_host({n: now[n].detach().float() - then[n].float() for n in then})


def traffic_pool(ctx) -> list:
    """The frozen pool of host batches the window cycles through, drawn
    from the seed by the traffic mix's generator,
    ``portbench/traffic/<generator>.py`` ``pool(traffic, config, seed)``."""
    from portbench.harness import load_module

    name = ctx.traffic["generator"]
    path = ctx.root / "portbench" / "traffic" / f"{name}.py"
    generator = load_module(path, f"portbench_traffic_{name}")
    return generator.pool(ctx.traffic, ctx.config, ctx.seed)


def prime(program, reference_steps: int, warm_steps: int) -> dict:
    """The program's first steps, through its own step call: the readings
    after ``reference_steps`` of them (``program.weights0`` holds the
    weights it started from; the step fills ``probe`` with the first
    step's accumulated sum and gradient, on the host), then more steps up to
    ``warm_steps`` in all, which warm every shape the window uses."""
    losses, probe = [], {}
    readings: Optional[dict] = None
    for t in range(max(reference_steps, warm_steps)):
        loss, _ok = program.step(OFF, probe if t == 0 else None)
        losses.append(float(loss))
        if t + 1 == reference_steps:
            readings = {"losses": losses[:reference_steps],
                        "sums": probe["sums"], "grads": probe["grads"],
                        "changes": program.changes()}
            program.weights0 = None
            probe.clear()
    return readings
