"""Ring-attention scaling shape over sequence-parallel ranks (the
counterpart of ``tools/ring_scaling.py``).

Times the ring-attention forward+backward of ALBERT's self-attention
(``models/albert.py`` with ``attention_impl="ring"``, over
``parallel/ring_attention.py``) at long S across sequence-parallel widths,
each rank its own process over gloo: all sharing the card (each
collective staged through host memory, ``parallel/mesh.py``), or on the
CPU when asked for. Not a speed figure (ranks sharing one card or one
host): the point is the SHAPE — per-rank score memory and work fall as
1/sp while the program runs end to end at every width.

    python -m dedloc_tpu_torch.tools.ring_scaling            # sp in {2, 4} x S in {16k, 32k}
    python -m dedloc_tpu_torch.tools.ring_scaling --wide     # and the sp=8 rows (8 ranks)
    python -m dedloc_tpu_torch.tools.ring_scaling --sp 2 --seq 512 --device cpu

One JSON line per (sp, S).
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from dedloc_tpu_torch.tools.ranks import start_ranks, wait_ranks

# the reference's widths and lengths; sp=8 needs 8 ranks and runs only
# when asked for
ROWS = [(2, 16384), (4, 16384), (4, 32768)]
WIDE_ROWS = [(8, 16384), (8, 32768)]
RUNS = 3


def score_block_bytes(sp: int, seq: int) -> int:
    """One ring step's score block per rank and per (batch, head): the
    rank's S/sp queries against one S/sp shard of keys, fp32."""
    return (seq // sp) ** 2 * 4


def measure(sp: int, seq: int, timeout: float = 1800.0,
            device_type: Optional[str] = None) -> dict:
    """One row: ``sp`` ranks (sharing the card unless ``device_type`` is
    "cpu") run the attention's forward+backward at length ``seq`` (B = 1),
    the first call timed apart from the mean of the next ``RUNS``."""
    from dedloc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device_type).type
    with tempfile.TemporaryDirectory(prefix="ring_scaling_") as work:
        wait_ranks(start_ranks(
            ["-m", "dedloc_tpu_torch.tools.ring_scaling", "--rank-worker", work,
             "--seq", str(seq), "--device", dev], sp, work, "ring", dev, timeout))
        with open(os.path.join(work, "out0.pkl"), "rb") as f:
            out = pickle.load(f)  # written by _rank_main
    return {
        "sp": sp, "seq": seq, "device": dev, "first_call_s": out["first_s"],
        "fwd_bwd_s": out["run_s"], "tok_per_s": seq / out["run_s"],
        "finite": out["finite"],
        "score_block_bytes_per_rank": score_block_bytes(sp, seq),
        "score_block_mb_per_rank": score_block_bytes(sp, seq) / 2 ** 20,
    }


def _rank_main(work: str, seq: int, device_type: str) -> None:
    from dedloc_tpu_torch.models.albert import AlbertConfig, AlbertSelfAttention, init_weights
    from dedloc_tpu_torch.parallel.mesh import init_slice, make_mesh

    torch.set_num_threads(1)
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    device = init_slice(world, device_type)
    mesh = make_mesh(world, ("seq",), device_type=device_type)
    cfg = AlbertConfig.tiny(max_position_embeddings=seq, attention_impl="ring",
                            ring_mesh=mesh)
    attn = AlbertSelfAttention(cfg)
    init_weights(attn, torch.Generator().manual_seed(0))
    attn.to(device)
    s = seq // world
    x = np.random.default_rng(0).normal(0, 1, (1, seq, cfg.hidden_size))
    x = torch.as_tensor(x[:, rank * s:(rank + 1) * s], dtype=cfg.dtype,
                        device=device).requires_grad_()
    bias = torch.zeros((1, s), dtype=torch.float32, device=device)
    params = list(attn.parameters())

    def fwd_bwd():
        loss = attn(x, bias).float().pow(2).mean()
        grads = torch.autograd.grad(loss, params + [x])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return loss, grads

    t0 = time.perf_counter()
    loss, grads = fwd_bwd()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(RUNS):
        loss, grads = fwd_bwd()
    run_s = (time.perf_counter() - t0) / RUNS
    finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)
    with open(os.path.join(work, f"out{rank}.pkl"), "wb") as f:
        pickle.dump({"first_s": first_s, "run_s": run_s, "finite": finite}, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sp", type=int, default=0, help="one width (with --seq)")
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--wide", action="store_true", help="also the sp=8 rows")
    ap.add_argument("--device", default=None,
                    help="cpu: the ranks run on the CPU (default: they share the card)")
    ap.add_argument("--rank-worker", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_worker:
        _rank_main(args.rank_worker, args.seq, args.device)
        return 0
    rows = [(args.sp, args.seq)] if args.sp else ROWS + (WIDE_ROWS if args.wide else [])
    for sp, seq in rows:
        print(json.dumps(measure(sp, seq, device_type=args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
