"""A tiny DeepSeek-V3 cell built as new files beside the real ones
(``tiny.add_cell``) and run through ``harness.run`` on the CPU: sound, it
reads ``correct``; with half the batch, a flipped update, or the routers'
correction-bias update left out or of the wrong sign in the program's
place, it fails its limits."""
import time

import pytest

from portbench import harness
from portbench.reference import compare
from portbench.tests import tiny

TINY = {"vocab_size": 256, "hidden_size": 32, "intermediate_size": 48,
        "moe_intermediate_size": 16, "num_hidden_layers": 3, "num_attention_heads": 2,
        "kv_lora_rank": 16, "qk_nope_head_dim": 8, "qk_rope_head_dim": 8, "v_head_dim": 8,
        "n_routed_experts": 8, "num_experts_per_tok": 3, "experts_held": 4, "layers_held": 3,
        "expert_rank": 1, "max_position_embeddings": 64}
TRAFFIC = {"generator": "packed_lm", "micro_batch": 2, "seq_length": 32, "accumulation": 2,
           "pool": 6, "median_length": 8, "sigma": 1.0, "zipf_s": 1.1}
# the program runs in float32 on the CPU: the limits sit at float32's noise
# (LAMB's first update is sign-like where a gradient is near 0, so the
# change's direction is left to change_gap)
LIMITS = {"loss_gap": 1e-4, "sum_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-4}
CELL = "tiny-moonlight.cpu"


def _root(tmp_path):
    root = tiny.checkout(tmp_path)
    tiny.add_cell(root, "tiny-moonlight", "moonlight-16b-a3b", TINY, TRAFFIC,
                  {"program": {},
                   "reference_steps": 2, "limits": dict(LIMITS)})
    return root


def test_a_sound_run_reads_correct(tmp_path):
    root = _root(tmp_path)
    result = harness.run(CELL, 2 ** 40 + 5, 0.5, False, time.perf_counter(),
                         device="cpu", root=root)
    assert result["correct"] is True, result["compared"]
    assert set(result["metrics"]) == {"samples_per_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault", [dict(half=True), dict(flip=True), dict(bias="off"),
                                   dict(bias="flip")])
def test_half_the_batch_or_a_flipped_update_fails(tmp_path, fault):
    numbers, broken, limits = tiny.readings(_root(tmp_path), CELL, 2 ** 33 + 1, **fault)
    assert compare.judge(numbers, limits), numbers
    assert not compare.judge(broken, limits), broken
