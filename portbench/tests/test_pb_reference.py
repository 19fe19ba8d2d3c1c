"""The plain references against the port's CPU path at a tiny size: the
program's readings fall inside the limits, the control's (the reference in
bfloat16 throughout, in the program's place) outside them."""
import json

import pytest
import torch

from portbench.reference import albert as ref_albert
from portbench.reference import compare, swav as ref_swav
from portbench.tests import tiny


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_albert_reference_matches_and_control_fails(tmp_path, seed):
    root = tiny.tiny_root(tmp_path)
    prog, control, limits = tiny.readings(root, "tiny-albert.cpu", seed,
                                          dtype=torch.bfloat16)
    assert compare.judge(prog, limits), prog
    assert not compare.judge(control, limits), control


def test_swav_reference_matches_fp32_trunk_and_control_fails(tmp_path):
    root = tiny.tiny_swav_fp32_root(tmp_path)
    prog, control, limits = tiny.readings(root, "tiny-swav32.cpu", 7,
                                          dtype=torch.bfloat16)
    assert compare.judge(prog, limits), prog
    assert not compare.judge(control, limits), control


def test_weight_decay_mask_is_the_ports_but_the_mlm_bias():
    from dedloc_tpu_torch.models.albert import AlbertConfig, AlbertForPreTraining
    from dedloc_tpu_torch.optim.lamb import albert_weight_decay_mask

    with torch.device("meta"):
        model = AlbertForPreTraining(AlbertConfig.tiny())
    params = dict(model.named_parameters())
    ours, theirs = ref_albert.weight_decay_mask(params), albert_weight_decay_mask(params)
    # the recipe's "bias" rule leaves the MLM output bias undecayed; the
    # port decides on the JAX leaf name "mlm_bias" and decays it (a zero
    # vector at init, so the first steps differ by wd x lr-sized terms)
    assert {k for k in ours if ours[k] != theirs[k]} == {"mlm_bias"}


def test_names_and_shapes_are_the_ports():
    from dedloc_tpu_torch.models.albert import AlbertConfig, AlbertForPreTraining
    from dedloc_tpu_torch.models.resnet import init_batch_stats
    from dedloc_tpu_torch.models.swav import SwAVConfig, SwAVModel

    c = json.load(open(tiny.REPO / "portbench/configs/albert-large.json"))
    with torch.device("meta"):
        albert = AlbertForPreTraining(AlbertConfig.large())
        swav = SwAVModel(SwAVConfig())
    assert {n: tuple(p.shape) for n, p in albert.named_parameters()} == {
        n: s for n, s, _k, _c in ref_albert.spec(c)}
    c = json.load(open(tiny.REPO / "portbench/configs/swav-resnet50.json"))
    assert {n: tuple(p.shape) for n, p in swav.named_parameters()} == {
        n: s for n, s, _k, _c in ref_swav.spec(c)}
    stats = init_batch_stats(swav)
    assert {k: tuple(v.shape) for k, v in stats.items()} == {
        f"{n}.{s}": (c_,) for n, c_ in ref_swav.batch_norms(c) for s in ("mean", "var")}
