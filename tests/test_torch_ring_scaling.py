"""``dedloc_tpu_torch/tools/ring_scaling.py`` at sp 2 and a short S: the
ring-attention forward+backward of ALBERT's self-attention runs end to end
on 2 gloo CPU ranks (asked for: the tool's ranks share the card by
default), and the per-rank score block falls as 1/sp^2 of the
sequence's (as 1/sp per query row)."""
import json

import pytest
import torch

from dedloc_tpu_torch.tools import ring_scaling as rs


def test_sp2_short_sequence_runs_and_reports_the_score_block():
    row = rs.measure(2, 256, timeout=120, device_type="cpu")
    assert row["sp"] == 2 and row["seq"] == 256 and row["finite"]
    assert row["device"] == "cpu"
    assert row["fwd_bwd_s"] > 0 and row["tok_per_s"] > 0
    assert row["score_block_bytes_per_rank"] == 128 * 128 * 4


def test_score_bytes_fall_with_the_width():
    for seq in (16384, 32768):
        sizes = [rs.score_block_bytes(sp, seq) for sp in (1, 2, 4, 8)]
        assert all(a == 4 * b for a, b in zip(sizes, sizes[1:]))
    # per query row: S/sp keys at a time
    assert rs.score_block_bytes(4, 16384) / (16384 // 4) == 16384 // 4 * 4


def test_the_default_rows_leave_sp8_to_the_wide_flag():
    assert all(sp in (2, 4) for sp, _ in rs.ROWS)
    assert all(sp == 8 for sp, _ in rs.WIDE_ROWS)
    json.dumps(rs.ROWS + rs.WIDE_ROWS)


def test_the_ranks_take_the_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rs.measure(2, 256, timeout=60)
