"""A tiny Kimi Linear cell built as new files beside the real ones
(``tiny.add_cell``) and run through ``harness.run`` on the CPU: sound, it
reads ``correct``; with half the batch, a flipped update, or the routers'
correction-bias update left out or of the wrong sign in the program's
place, it fails its limits. The tiny model has every layer kind: KDA with
the dense FFN, KDA with experts, NoPE latent attention with experts."""
import time

import pytest

from portbench import harness
from portbench.reference import compare
from portbench.tests import tiny

TINY = {"vocab_size": 256, "hidden_size": 32, "intermediate_size": 48,
        "moe_intermediate_size": 16, "num_hidden_layers": 3, "num_attention_heads": 2,
        "kv_lora_rank": 16, "qk_nope_head_dim": 8, "qk_rope_head_dim": 8, "v_head_dim": 8,
        "num_experts": 16, "num_experts_per_token": 8, "experts_held": 8, "layers_held": 3,
        "expert_rank": 1, "model_max_length": 64,
        "linear_attn_config": {"full_attn_layers": [3], "head_dim": 16, "kda_layers": [1, 2],
                               "num_heads": 2, "short_conv_kernel_size": 4}}
TRAFFIC = {"generator": "packed_lm", "micro_batch": 2, "seq_length": 40, "accumulation": 2,
           "pool": 6, "median_length": 8, "sigma": 1.0, "zipf_s": 1.1}
# the program runs in float32 on the CPU (KDA as the chunked mirror, chunks
# of 16; the reference's chunks are 64): the limits sit at float32's noise
LIMITS = {"loss_gap": 1e-4, "sum_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-4}
CELL = "tiny-kimi.cpu"


def _root(tmp_path):
    root = tiny.checkout(tmp_path)
    tiny.add_cell(root, "tiny-kimi", "kimi-linear-48b-a3b", TINY, TRAFFIC,
                  {"program": {}, "reference_steps": 2, "limits": dict(LIMITS)})
    return root


def test_a_sound_run_reads_correct(tmp_path):
    root = _root(tmp_path)
    result = harness.run(CELL, 2 ** 40 + 7, 0.5, False, time.perf_counter(),
                         device="cpu", root=root)
    assert result["correct"] is True, result["compared"]
    assert set(result["metrics"]) == {"samples_per_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault", [dict(half=True), dict(flip=True), dict(bias="off"),
                                   dict(bias="flip")])
def test_half_the_batch_or_a_flipped_update_fails(tmp_path, fault):
    numbers, broken, limits = tiny.readings(_root(tmp_path), CELL, 2 ** 33 + 3, **fault)
    assert compare.judge(numbers, limits), numbers
    assert not compare.judge(broken, limits), broken


def test_the_driver_hands_over_the_kernel_shapes(tmp_path):
    root = _root(tmp_path)
    ctx = harness.resolve(CELL, root)
    ctx.seed, ctx.device = 5, "cpu"
    driver = harness.load_module(ctx.driver_path, "pb_kimi_driver")
    program = driver.build(ctx)
    from portbench.drivers.common import Spans

    program.step(Spans(on=True))
    shapes = program.kernel_shapes
    program.close()
    assert shapes["mla_flash"] == (2, 40, 2, 16, 8)
    assert shapes["kda_chunk"] == (2, 40, 2, 16, 16, 16)
    assert len(shapes["expert_loads"]) == 2 and len(shapes["expert_loads"][0]) == 8
    assert len(shapes["kda_state_norm"]) == 2 and min(shapes["kda_state_norm"]) > 0
