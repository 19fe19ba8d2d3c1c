"""``metrics/_regions.py`` on hand-built chrome traces of two host threads:
a forward region, a backward operation linked to it by a flow event (or,
without one, charged to its phase alone), an idle gap ended by a launch
inside ``opt_apply``, an operation outside every region; and the new
readers on a trace without ``dedloc.`` regions."""
import types

import pytest

from portbench import harness
from portbench.metrics import _regions

MAIN, GRAD = 1, 2
NEW = ("fwd_device_ms", "bwd_device_ms", "boundary_device_ms", "norm_device_ms",
       "fwd_idle_ms", "bwd_idle_ms", "boundary_idle_ms", "untraced_device_share")


def _x(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid, "ts": ts,
            "dur": dur, "args": args}


def _launch(tid, ts, corr, kernel_ts, kernel_dur, cat="cuda_runtime"):
    return [_x(cat, "cudaLaunchKernel", tid, ts, 1.0, correlation=corr),
            {"ph": "X", "cat": "kernel", "name": f"k{corr}", "pid": 0, "tid": 7,
             "ts": kernel_ts, "dur": kernel_dur, "args": {"correlation": corr}}]


def trace(regions=True, flows=True):
    """A forward ``aten::mm`` in ``fwd/attention`` (its kernel 40-50 us), a
    ``norm`` kernel (52-56), its backward node on autograd's thread while
    the main thread waits in ``bwd`` (kernel 170-190, the device idle from
    56), a launch in ``opt_apply`` after a gap (330-340) and one outside
    every region after another (430-440)."""
    name = (lambda n: "dedloc." + n) if regions else (lambda n: "other." + n)
    ev = [
        _x("cpu_op", name("fwd"), MAIN, 0, 100),
        _x("cpu_op", name("attention"), MAIN, 10, 50),
        _x("cpu_op", "aten::mm", MAIN, 20, 10),
        *_launch(MAIN, 22, 1, 40, 10),
        _x("cpu_op", name("norm"), MAIN, 35, 10),
        _x("cpu_op", "aten::mul", MAIN, 36, 5),
        *_launch(MAIN, 37, 2, 52, 4, cat="cuda_driver"),
        _x("cpu_op", name("bwd"), MAIN, 100, 200),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", GRAD,
           150, 50),
        _x("cpu_op", "MmBackward0", GRAD, 151, 48),
        *_launch(GRAD, 160, 3, 170, 20),
        _x("cpu_op", name("opt_apply"), MAIN, 300, 100),
        _x("cpu_op", "aten::add_", MAIN, 310, 10),
        *_launch(MAIN, 312, 4, 330, 10),
        _x("cpu_op", "aten::zeros", MAIN, 410, 10),
        *_launch(MAIN, 412, 5, 430, 10),
    ]
    if flows:
        ev += [{"ph": "s", "cat": "fwdbwd", "name": "fwdbwd", "id": 1, "pid": 7,
                "tid": MAIN, "ts": 20},
               {"ph": "f", "cat": "fwdbwd", "name": "fwdbwd", "id": 1, "pid": 7,
                "tid": GRAD, "ts": 151, "bp": "e"}]
    return {"traceEvents": ev}


@pytest.mark.parametrize("flows", [True, False])
def test_attribution_of_a_two_thread_trace(flows):
    t = _regions.attribute(trace(flows=flows), steps=1)
    ms = lambda us: pytest.approx(us * 1e-3)
    # the backward kernel: in the bwd phase, in the forward's region if linked
    bwd = "bwd/attention" if flows else "bwd"
    assert t["busy_ms"] == ms(10 + 4 + 20 + 10 + 10)
    assert t["idle_ms"] == ms(2 + 114 + 140 + 90)
    assert t["paths"]["fwd/attention"] == {"device_ms": ms(10), "idle_ms": 0.0,
                                           "ops": 1}
    assert t["paths"]["fwd/attention/norm"]["device_ms"] == ms(4)
    assert t["paths"][bwd] == {"device_ms": ms(20), "idle_ms": ms(114), "ops": 1}
    assert t["phases"]["opt_apply"] == {"device_ms": ms(10), "idle_ms": ms(140),
                                        "ops": 1}
    assert t["untraced"] == {"device_ms": ms(10), "idle_ms": ms(90), "ops": 1}
    assert set(t["phases"]) == {"fwd", "bwd", "opt_apply"}
    assert [g[0] for g in t["gaps"]] == [
        "opt_apply / aten::add_",
        f"{bwd} / autograd::engine::evaluate_function: MmBackward0",
        "untraced / aten::zeros", "fwd/attention/norm / aten::mul"]
    run = types.SimpleNamespace(regions=t)
    read = {n: harness.load_module(harness.ROOT / "portbench" / "metrics" / f"{n}.py",
                                   f"pb_regions_{n}").read(run) for n in NEW}
    assert read == {"fwd_device_ms": ms(14), "bwd_device_ms": ms(20),
                    "boundary_device_ms": ms(10), "norm_device_ms": ms(4),
                    "fwd_idle_ms": ms(2), "bwd_idle_ms": ms(114),
                    "boundary_idle_ms": ms(140),
                    "untraced_device_share": pytest.approx(100 * 10 / 54)}


def test_steps_divide_every_table():
    one, three = (_regions.attribute(trace(), steps=n) for n in (1, 3))
    assert three["busy_ms"] == pytest.approx(one["busy_ms"] / 3)
    assert three["phases"]["bwd"]["ops"] == pytest.approx(1 / 3)


@pytest.mark.parametrize("name", NEW)
def test_each_reader_is_none_without_regions(name):
    assert _regions.attribute(trace(regions=False), steps=1) is None
    reader = harness.load_module(harness.ROOT / "portbench" / "metrics" / f"{name}.py",
                                 f"pb_regions_none_{name}")
    assert reader.read(types.SimpleNamespace(regions=None)) is None
    # off the card no stretch is taken
    cpu = types.SimpleNamespace(cell=types.SimpleNamespace(device="cpu"),
                                profile={"events": []})
    assert reader.read(cpu) is None and cpu.regions is None
