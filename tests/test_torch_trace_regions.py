"""The port's device-trace regions (``telemetry/steps.py`` ``region``).

With no profiler a region is the shared no-op and no profiler range is
entered during a step. Under ``torch.profiler`` one tiny ALBERT step (remat
``fused_ln`` and ``dots_no_batch_attn``) and one tiny SwAV step, each the
move to the device, one accumulated micro-batch, the mean with the clip and
the flat apply, hold every region of the training step nested as the step
nests them. The loss and every gradient are bitwise the same with the
profiler on and off, and a step-phase record shows as ``dedloc.<phase>``
with its host-clock record unchanged."""
import json
import os
import tempfile

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dedloc_tpu_torch.averaging.device_flat import DeviceFlatPipeline
from dedloc_tpu_torch.collaborative.optimizer import _fused_mean_clip
from dedloc_tpu_torch.core.config import SwAVTrainingArguments, TrainingArguments
from dedloc_tpu_torch.data.multicrop import MultiCropSpec, crop_groups
from dedloc_tpu_torch.models import swav
from dedloc_tpu_torch.models.albert import (
    AlbertConfig,
    AlbertForPreTraining,
    fused_ln_for_policy,
    init_weights,
)
from dedloc_tpu_torch.optim.lars import Lars
from dedloc_tpu_torch.optim.schedules import linear_warmup_cosine_annealing
from dedloc_tpu_torch.parallel.train_step import (
    TrainState,
    make_accumulate_step,
    make_flat_apply_step,
    zeros_like_grads,
)
from dedloc_tpu_torch.roles.common import (
    build_flat_opt_factory,
    build_loss_fn,
    build_optimizer,
    drop_collator_keys,
)
from dedloc_tpu_torch.roles.swav import _build_flat_lars_factory
from dedloc_tpu_torch.telemetry import registry, steps

B, S, P = 2, 16, 4


class AlbertStep:
    """One tiny ALBERT peer's step, as the benchmark's driver composes it."""

    def __init__(self, policy: str):
        cfg = AlbertConfig.tiny(remat_policy=policy,
                                fused_ln=fused_ln_for_policy(policy),
                                attention_impl="flash")
        model = init_weights(AlbertForPreTraining(cfg), torch.Generator().manual_seed(0))
        params = dict(model.named_parameters())
        args = TrainingArguments()
        self.state = TrainState.create(params, build_optimizer(args))
        self.accumulate = make_accumulate_step(build_loss_fn(model))
        acc = zeros_like_grads(params)
        spec = DeviceFlatPipeline.for_tree(acc).spec
        self.apply = make_flat_apply_step(build_flat_opt_factory(args)(spec, params),
                                          spec, from_tree=True)
        rng = np.random.default_rng(1)
        self.batch = {
            "input_ids": rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32),
            "attention_mask": np.ones((B, S), np.int32),
            "token_type_ids": np.zeros((B, S), np.int32),
            "mlm_positions": np.tile(np.arange(1, P + 1, dtype=np.int32), (B, 1)),
            "mlm_label_ids": rng.integers(1, cfg.vocab_size, (B, P)).astype(np.int32),
            "mlm_weights": np.ones((B, P), np.float32),
            "sop_labels": np.array([0, 1], np.int32),
        }

    def __call__(self):
        """(loss, the clipped mean gradient, the parameters after the apply)."""
        params = self.state.params
        batch = drop_collator_keys(self.batch, device="cpu")
        acc, n, metrics = self.accumulate(params, zeros_like_grads(params), 0, batch)
        mean = _fused_mean_clip(acc, n, 1.0)
        self.state, _ok = self.apply(self.state, mean)
        return metrics["loss"], mean, self.state.params


class SwAVStep:
    """One tiny SwAV peer's step with the queue on, as the driver composes it."""

    def __init__(self):
        cfg = swav.SwAVConfig.tiny(queue_length=16)
        model, params, self.stats = swav.init_swav(cfg, 0, "cpu")
        self.queue = swav.SwAVQueue.create(cfg, torch.Generator().manual_seed(1))
        args = SwAVTrainingArguments()
        tx = Lars(learning_rate=linear_warmup_cosine_annealing(
            args.learning_rate, args.warmup_steps, args.total_steps),
            momentum=args.momentum, weight_decay=args.weight_decay,
            trust_coefficient=args.trust_coefficient)
        self.state = TrainState.create(params, tx)
        self.accumulate = swav.make_swav_accumulate_step(model, cfg)
        acc = zeros_like_grads(params)
        spec = DeviceFlatPipeline.for_tree(acc).spec
        self.apply = make_flat_apply_step(
            _build_flat_lars_factory(args)(spec, params), spec,
            post_apply=swav.make_prototype_post_apply(), from_tree=True)
        rng = np.random.default_rng(2)
        self.crops = [rng.standard_normal((n, size, size, 3)).astype(np.float32)
                      for n, size in crop_groups(MultiCropSpec.tiny(), 4)]

    def __call__(self):
        params = self.state.params
        crops = swav.crop_tensors(self.crops, "cpu")
        acc, n, self.stats, self.queue, metrics = self.accumulate(
            params, self.stats, self.queue, zeros_like_grads(params), 0, crops, 0, True)
        mean = _fused_mean_clip(acc, n, 1.0)
        self.state, _ok = self.apply(self.state, mean)
        return metrics["loss"], mean, self.state.params


STEPS = {"albert-fused_ln": lambda: AlbertStep("fused_ln"),
         "albert-dots_no_batch_attn": lambda: AlbertStep("dots_no_batch_attn"),
         "swav": SwAVStep}

ALBERT = {("h2d", None), ("fwd", None), ("embed", "fwd"), ("norm", "embed"),
          ("attention", "fwd"), ("norm", "attention"), ("ffn", "fwd"),
          ("norm", "ffn"), ("head", "fwd"), ("norm", "head"), ("loss", "fwd"),
          ("bwd", None), ("attention", "bwd"), ("ffn", "bwd"),
          ("accumulate", None), ("mean_clip", None), ("opt_apply", None)}
NESTED = {
    "albert-fused_ln": ALBERT | {("norm", "bwd")},  # the kernel's backward
    "albert-dots_no_batch_attn": ALBERT,
    "swav": {("h2d", None), ("fwd", None), ("queue", "fwd"), ("norm", "fwd"),
             ("head", "fwd"), ("norm", "head"), ("loss", "fwd"),
             ("sinkhorn", "loss"), ("bwd", None), ("accumulate", None),
             ("queue", None), ("mean_clip", None), ("opt_apply", None)},
}


def _traced(fn):
    """(what ``fn`` returns, the regions of its trace: (name, parent) for
    each, the innermost enclosing region on the same thread the parent)."""
    torch.manual_seed(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    regions = sorted((e for e in events if e.get("ph") == "X"
                      and e["name"].startswith("dedloc.")),
                     key=lambda e: (e["ts"], -e["dur"]))
    pairs, stacks = [], {}
    for e in regions:
        stack = stacks.setdefault(e["tid"], [])
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"]:
            stack.pop()
        parent = stack[-1]["name"][len("dedloc."):] if stack else None
        pairs.append((e["name"][len("dedloc."):], parent))
        stack.append(e)
    return out, pairs


@pytest.mark.parametrize("kind", ["albert-fused_ln", "swav"])
def test_off_a_region_is_the_shared_noop_and_enters_nothing(kind, monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert steps.region("fwd") is steps._NOOP
    entered = []
    fast = steps._RecordFunctionFast
    monkeypatch.setattr(steps, "_RecordFunctionFast",
                        lambda name: entered.append(name) or fast(name))
    enter = torch.autograd.profiler.record_function.__enter__

    def counted(self):
        entered.append(self.name)
        return enter(self)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", counted)
    step = STEPS[kind]()
    step()
    assert entered == []


@pytest.mark.parametrize("kind", sorted(NESTED))
def test_a_traced_step_holds_every_region_nested(kind):
    _out, pairs = _traced(STEPS[kind]())
    assert NESTED[kind] <= set(pairs)
    # nothing of the forward or the step around it opens inside a backward
    assert not {(n, p) for n, p in pairs if p == "bwd"} & {
        ("embed", "bwd"), ("head", "bwd"), ("loss", "bwd"), ("fwd", "bwd")}
    # a normalisation is a leaf: a remat recompute opens no region in one
    assert not [n for n, p in pairs if p in ("norm", "sinkhorn")]
    names = {n for n, _p in pairs}
    phases = {"h2d", "fwd", "bwd", "accumulate", "mean_clip", "opt_apply"}
    assert {n for n, p in pairs if p is None} <= phases | {"queue"}
    assert all(len(n) <= 24 for n in names)


@pytest.mark.parametrize("kind", sorted(NESTED))
def test_loss_and_gradients_are_bitwise_equal_traced_and_not(kind):
    torch.manual_seed(0)
    plain = STEPS[kind]()()
    traced, _pairs = _traced(STEPS[kind]())
    assert torch.equal(plain[0], traced[0])
    for got, want in ((traced[1], plain[1]), (traced[2], plain[2])):
        assert sorted(got) == sorted(want)
        for name in want:
            assert torch.equal(got[name], want[name]), name


class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        self.now += 0.25
        return self.now


def _recorded(through_module: bool):
    """A step record of two phases on a ticking clock."""
    tele = registry.Telemetry(clock=_Clock())
    recorder = steps.StepRecorder(telemetry=tele)
    with recorder.step(step=7, samples=4) as ctx:
        with (steps.phase("fwd_bwd") if through_module else ctx.phase("fwd_bwd")):
            torch.ones(4).sum()
        with steps.phase("opt_apply"):
            torch.ones(4).mul(2)
    return recorder.records[-1]


@pytest.mark.parametrize("through_module", [False, True])
def test_a_recorded_phase_shows_as_its_region(through_module):
    plain = _recorded(through_module)
    traced, pairs = _traced(lambda: _recorded(through_module))
    assert traced == plain
    assert plain["phases"] == {"fwd_bwd": 0.25, "opt_apply": 0.25}
    assert ("fwd_bwd", None) in pairs and ("opt_apply", None) in pairs
