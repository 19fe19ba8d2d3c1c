"""The port's hook pipeline and phase-loop Trainer, as the JAX package's
``tests/test_hooks.py`` and ``tests/test_trainer.py`` hold theirs: dispatch
order, the NaN check, checkpoint and publish cadences, the default
pipeline, the device-memory hook, and the trainer's phases, stop rules and
perf timers (the loss a tensor: the loop waits for it with
``block_on_device``)."""
import itertools
import logging

import pytest
import torch

from dedloc_tpu_torch.core.hooks import (
    CheckNanLossHook,
    CheckpointHook,
    DeviceStatsHook,
    Hook,
    HookList,
    LoopContext,
    MetricsPublisherHook,
    default_hooks,
)
from dedloc_tpu_torch.core.trainer import Trainer


class Recorder(Hook):
    def __init__(self):
        self.events = []

    def __getattribute__(self, name):
        if name.startswith("on_"):
            return lambda ctx: object.__getattribute__(self, "events").append(name)
        return object.__getattribute__(self, name)


def test_dispatch_order_and_events():
    r1, r2 = Recorder(), Recorder()
    hooks = HookList([r1, r2])
    ctx = LoopContext()
    for ev in ("on_start", "on_step_begin", "on_loss", "on_step_end", "on_end"):
        hooks.dispatch(ev, ctx)
    assert r1.events == r2.events == [
        "on_start", "on_step_begin", "on_loss", "on_step_end", "on_end",
    ]


def test_dispatch_rejects_unknown_event():
    with pytest.raises(ValueError):
        HookList().dispatch("on_banana", LoopContext())


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_nan_loss_hook_raises(bad):
    hook = CheckNanLossHook()
    ctx = LoopContext(loss=1.0)
    hook.on_loss(ctx)  # finite: fine
    ctx.loss = bad
    with pytest.raises(FloatingPointError):
        hook.on_loss(ctx)


def test_checkpoint_hook_cadence():
    saves = []
    hook = CheckpointHook(lambda ctx: saves.append(ctx.local_step), every=3)
    ctx = LoopContext()
    for step in range(1, 8):
        ctx.local_step = step
        hook.on_step_end(ctx)
    hook.on_phase_end(ctx)
    assert saves == [3, 6, 7]  # every-3 plus phase-end


def test_metrics_publisher_fires_on_global_step_advance():
    published = []
    hook = MetricsPublisherHook(lambda ctx: published.append(ctx.global_step))
    ctx = LoopContext()
    for local, global_ in [(1, 0), (2, 0), (3, 1), (4, 1), (5, 2)]:
        ctx.local_step, ctx.global_step = local, global_
        hook.on_step_end(ctx)
    assert published == [0, 1, 2]


def test_default_hooks_compose():
    hooks = default_hooks(save_fn=lambda ctx: None, save_every=10,
                          device_stats_every=5)
    assert [type(h).__name__ for h in hooks.hooks] == [
        "CheckNanLossHook", "LogLossLrEtaHook", "LogPerfMetricsHook",
        "DeviceStatsHook", "CheckpointHook"]
    ctx = LoopContext(loss=0.5, local_step=10, max_steps=100)
    hooks.dispatch("on_phase_start", ctx)
    hooks.dispatch("on_loss", ctx)
    hooks.dispatch("on_step_end", ctx)


def test_device_stats_hook_logs_the_card_or_nothing(caplog):
    with caplog.at_level(logging.INFO, logger="dedloc_tpu_torch"):
        DeviceStatsHook(log_every=1).on_step_end(LoopContext(local_step=1))
        DeviceStatsHook(log_every=2).on_step_end(LoopContext(local_step=3))
    lines = [r.getMessage() for r in caplog.records if "device memory" in r.getMessage()]
    if torch.cuda.is_available():
        assert len(lines) == 1 and "cuda:0" in lines[0]
    else:
        assert lines == []


def counting_step(state, batch):
    return state + 1, {"loss": torch.tensor(1.0 / (state + 1)), "lr": 0.1,
                       "global_step": state + 1}


def test_trainer_runs_to_max_steps():
    events = []

    class Spy(Hook):
        def on_phase_start(self, ctx):
            events.append(("phase_start", ctx.phase))

        def on_phase_end(self, ctx):
            events.append(("phase_end", ctx.phase))

        def on_step_end(self, ctx):
            events.append(("step", ctx.local_step))

    trainer = Trainer(counting_step, hooks=HookList([Spy()]))
    state, ctx = trainer.train(0, itertools.repeat(None), max_steps=5,
                               steps_per_phase=2)
    assert state == 5
    assert ctx.local_step == 5 and ctx.global_step == 5
    assert ctx.lr == pytest.approx(0.1)
    assert ctx.loss == pytest.approx(1 / 5)
    assert events.count(("phase_start", 0)) == 1
    assert ("phase_end", 2) in events
    assert [e for e in events if e[0] == "step"] == [("step", i) for i in range(1, 6)]


def test_trainer_stops_on_data_exhaustion():
    trainer = Trainer(counting_step, hooks=HookList())
    state, ctx = trainer.train(0, iter([None, None]), max_steps=100)
    assert state == 2 and ctx.should_stop


def test_trainer_nan_hook_raises():
    def nan_step(state, batch):
        return state, {"loss": torch.tensor(float("nan"))}

    trainer = Trainer(nan_step, hooks=HookList([CheckNanLossHook()]))
    with pytest.raises(FloatingPointError):
        trainer.train(0, itertools.repeat(None), max_steps=3)


def test_trainer_collects_perf_stats():
    trainer = Trainer(counting_step, hooks=HookList())
    _, ctx = trainer.train(0, itertools.repeat(None), max_steps=3)
    report = ctx.perf.report()
    assert report["read_sample"]["count"] == 3
    assert report["train_step"]["count"] == 3
    assert report["hooks"]["count"] == 3
