"""Read a sustained run of the port: a solo trainer on the card, or a
``hetero_converge.sh`` fleet, from the logs it leaves under ``$RUN``.

    python -m dedloc_tpu_torch.tools.sustained summary RUN --corpus CORPUS
        one JSON object: the card trainer's curve (MLM and total loss,
        samples/s and step time against wall clock and global step, the
        first step whose MLM loss falls below the corpus's unigram entropy
        and whether the mean of the last 100 steps is below it,
        kernel launches per boundary), the fleet's rounds and group sizes,
        and the peers' states compared at common steps
    python -m dedloc_tpu_torch.tools.sustained hashes RUN --watch SECONDS
        while a fleet runs: hash each checkpointed step that two peers
        hold, as soon as both are written (the card trainer keeps only
        its newest few), into RUN/state_hashes.jsonl
    python -m dedloc_tpu_torch.tools.sustained monitor RUN
        one screen of a live fleet run (dedloc_tpu_torch/tools/run_monitor.sh)
    python -m dedloc_tpu_torch.tools.sustained swav LOG
        a SwAV peer's loss against global step and wall clock, from the
        role's log lines
    python -m dedloc_tpu_torch.tools.sustained matched LOG_A LOG_B
        two train logs' losses at the global steps both logged (a fleet's
        card trainer against a solo run)

File names are those of ``tools/hetero_converge.sh``'s runs:
``trainer_tpu.log`` and ``train_log_tpu.jsonl`` are the card trainer's,
``trainer_vol<i>.log`` / ``train_log_vol<i>.jsonl`` the volunteers',
``outputs`` / ``out_vol<i>`` their checkpoints.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import re
import statistics
import time
from typing import Dict, List, Optional

import numpy as np

from dedloc_tpu_torch.utils.jsonl import load_jsonl_rows

APPLIED = re.compile(r"global step (\d+) applied \(group=(\d+)")
SWAV_STEP = re.compile(r"^\[([\d-]+ [\d:.]+)\].*global step (\d+): loss ([-\d.naif]+)")
QUEUE = re.compile(r"queue engaged at global step (\d+)")
# kernel launches per accumulation boundary of the S=512 and S=128 paths
# at accumulation 2 (24 block applications per micro-batch)
CARD_LAUNCHES = {"flash_fwd": 48, "flash_bwd_dkdv": 48, "flash_bwd_dq": 48,
                 "ln_fwd": 96, "ln_bwd": 96}
MARKS_S = (60,) + tuple(range(300, 3601, 300))
PEER_DIRS = {"card": "outputs", "vol1": "out_vol1", "vol2": "out_vol2"}


def _rows(path: str) -> List[dict]:
    return load_jsonl_rows([path], warn=lambda _msg: None, missing_ok=True)


def applied_rounds(role_log: str) -> List[tuple]:
    """[(global step, group size)] a peer applied, from its role log."""
    if not os.path.exists(role_log):
        return []
    with open(role_log, errors="replace") as f:
        return [(int(m.group(1)), int(m.group(2)))
                for m in map(APPLIED.search, f) if m]


def launches_per_boundary(rows: List[dict]) -> Dict[str, List[float]]:
    """Each wrapper's launches per boundary between consecutive records
    (the counts are cumulative in the trainer's process)."""
    out: Dict[str, List[float]] = {}
    prev_b, prev = 0, None
    for r in rows:
        launches = r.get("kernel_launches") or {}
        nb = r["boundaries"] - prev_b
        if nb > 0:
            for k, v in launches.items():
                before = prev.get(k, 0) if prev else 0
                out.setdefault(k, []).append((v - before) / nb)
        prev_b, prev = r["boundaries"], launches
    return out


def curve(rows: List[dict], entropy: Optional[float],
          expected: Optional[Dict[str, int]] = CARD_LAUNCHES,
          smooth: int = 10, sustain: int = 100) -> dict:
    """The trainer's curve from its train log: loss (total and MLM) at
    fixed wall times and steps, step time, samples/s, and the first
    global step whose MLM loss (and whose mean over ``smooth`` steps)
    falls below ``entropy``. Near the mark the loss sits on a plateau
    where a short mean dips below and comes back: the run has crossed it
    (``sustained``) only when the mean MLM loss of its last ``sustain``
    steps is below it."""
    if not rows:
        return {"steps": 0}
    steps = [r["step"] for r in rows]
    walls = [r["wall_s"] for r in rows]
    mlm = [r.get("mlm_loss", r["loss"]) for r in rows]
    gaps = [(walls[i] - walls[i - 1]) / max(steps[i] - steps[i - 1], 1)
            for i in range(1, len(rows))]
    half = gaps[len(gaps) // 2:]
    out = dict(
        steps=len(rows), first_step=steps[0], last_step=steps[-1],
        wall_s=walls[-1], first_loss=rows[0]["loss"], last_loss=rows[-1]["loss"],
        first_mlm_loss=mlm[0], last_mlm_loss=mlm[-1],
        step_s_median=statistics.median(gaps) if gaps else None,
        step_s_median_second_half=statistics.median(half) if half else None,
        samples_per_step=statistics.median(r["samples"] for r in rows),
        samples_per_s_median=statistics.median(r["samples_per_second"] for r in rows),
        finite=all(math.isfinite(r["loss"]) for r in rows),
        max_memory_allocated=rows[-1].get("max_memory_allocated"),
    )
    out["at_wall_s"] = {
        str(t): dict(step=r["step"], loss=r["loss"], mlm_loss=r.get("mlm_loss"))
        for t in MARKS_S
        for r in [next((x for x in rows if x["wall_s"] >= t), None)] if r}
    every = max(1, len(rows) // 12)
    out["at_step"] = {str(r["step"]): dict(wall_s=round(r["wall_s"], 1),
                                            loss=r["loss"], mlm_loss=r.get("mlm_loss"))
                      for r in rows[::every] + [rows[-1]]}
    if entropy is not None:
        out["unigram_entropy_nats"] = entropy
        first = next((r for r, m in zip(rows, mlm) if m < entropy), None)
        window = next((rows[i] for i in range(smooth - 1, len(rows))
                       if statistics.mean(mlm[i - smooth + 1:i + 1]) < entropy), None)
        out["below_entropy"] = dict(
            first_step=first["step"] if first else None,
            first_wall_s=first["wall_s"] if first else None,
            mean_of_10_step=window["step"] if window else None,
            mean_of_10_wall_s=window["wall_s"] if window else None,
            mean_of_last=statistics.mean(mlm[-sustain:]),
            last_steps=min(sustain, len(mlm)),
            sustained=len(mlm) >= sustain and statistics.mean(mlm[-sustain:]) < entropy)
    per = launches_per_boundary(rows)
    out["launches_per_boundary"] = {k: sorted(set(v)) for k, v in per.items()}
    if expected is not None:
        out["launches_as_expected"] = bool(per) and all(
            set(per.get(k, [])) == {float(n)} for k, n in expected.items())
    return out


def participation(run: str) -> dict:
    """``tools/participation_summary.py``'s reading of a fleet run: the
    card trainer's applied steps and group sizes, and the share of its
    rounds each volunteer averaged in."""
    card = applied_rounds(os.path.join(run, "trainer_tpu.log"))
    hist: Dict[int, int] = {}
    for _, g in card:
        hist[g] = hist.get(g, 0) + 1
    out = {"card_steps": len(card),
           "group_hist": {str(k): v for k, v in sorted(hist.items())}}
    steps = {s for s, _ in card}
    for i in (1, 2):
        vol = applied_rounds(os.path.join(run, f"trainer_vol{i}.log"))
        joined = {s for s, g in vol if g >= 2}
        out[f"vol{i}_applied"] = len(vol)
        out[f"vol{i}_joined_rounds"] = sorted(joined & steps)
        out[f"vol{i}_participation"] = (
            round(len(joined & steps) / len(steps), 3) if steps else 0.0)
        out[f"vol{i}_loaded_state"] = _count(
            os.path.join(run, f"trainer_vol{i}.log"), "loaded state from peers")
    aux = os.path.join(run, "aux.log")
    out["aux_rounds"] = _count(aux, "joined averaging round")
    return out


def _count(path: str, needle: str) -> int:
    if not os.path.exists(path):
        return 0
    with open(path, errors="replace") as f:
        return f.read().count(needle)


def state_digest(path: str) -> tuple:
    """(sha256 of a checkpoint's state, its tensors by name)."""
    from dedloc_tpu_torch.utils.checkpoint import load_checkpoint

    named, _meta = load_checkpoint(path)
    h = hashlib.sha256()
    for name in sorted(named):
        h.update(name.encode())
        h.update(np.ascontiguousarray(named[name]).tobytes())
    return h.hexdigest(), named


def _checkpoints(run: str) -> Dict[str, Dict[int, str]]:
    out = {}
    for peer, sub in PEER_DIRS.items():
        d = os.path.join(run, sub)
        out[peer] = ({int(n.split("-")[1]): os.path.join(d, n) for n in os.listdir(d)
                      if n.startswith("checkpoint-")} if os.path.isdir(d) else {})
    return out


def compare_step(paths: Dict[str, str]) -> dict:
    """Hashes of the peers' states at one step and, where they differ,
    the largest absolute difference of any element from the card's."""
    digests, trees = {}, {}
    for peer, path in paths.items():
        try:
            digests[peer], trees[peer] = state_digest(path)
        except (OSError, ValueError, KeyError) as e:  # deleted or half-read
            digests[peer] = f"unreadable: {e}"
    row = {"hashes": digests,
           "equal": len(set(digests.values())) == 1}
    ref = trees.get("card") or next(iter(trees.values()), None)
    if not row["equal"] and ref is not None:
        row["max_abs_diff"] = {
            p: max(float(np.max(np.abs(t[k].astype(np.float64) - ref[k])))
                   for k in ref if k in t and t[k].shape == ref[k].shape)
            for p, t in trees.items() if t is not ref}
    return row


def watch_hashes(run: str, seconds: float, period: float = 2.0) -> List[dict]:
    """Hash every step that two or more peers hold a checkpoint of, once,
    until ``seconds`` have passed; appends each to RUN/state_hashes.jsonl."""
    done, rows = set(), []
    deadline = time.time() + seconds
    while time.time() < deadline:
        ckpts = _checkpoints(run)
        steps: Dict[int, Dict[str, str]] = {}
        for peer, by_step in ckpts.items():
            for s, p in by_step.items():
                steps.setdefault(s, {})[peer] = p
        for s, paths in sorted(steps.items()):
            if s in done or len(paths) < 2:
                continue
            done.add(s)
            row = dict(step=s, peers=sorted(paths), **compare_step(paths))
            rows.append(row)
            with open(os.path.join(run, "state_hashes.jsonl"), "a") as f:
                f.write(json.dumps(row) + "\n")
        time.sleep(period)
    return rows


def summary(run: str, corpus: Optional[str]) -> dict:
    entropy = None
    if corpus:
        with open(os.path.join(corpus, "corpus.json")) as f:
            entropy = json.load(f)["unigram_entropy_nats"]
    out = {"run": run,
           "card": curve(_rows(os.path.join(run, "train_log_tpu.jsonl")), entropy)}
    if os.path.exists(os.path.join(run, "coordinator.log")):
        out["participation"] = participation(run)
        hashes = _rows(os.path.join(run, "state_hashes.jsonl"))
        out["state_hashes"] = dict(
            steps_compared=len(hashes),
            equal=[r["step"] for r in hashes if r["equal"]],
            differ={str(r["step"]): r.get("max_abs_diff") for r in hashes
                    if not r["equal"]})
        for i in (1, 2):
            rows = _rows(os.path.join(run, f"train_log_vol{i}.jsonl"))
            out[f"vol{i}"] = curve(rows, entropy, expected=None) if rows else {"steps": 0}
    return out


def swav_curve(log_path: str) -> dict:
    """A SwAV peer's curve from its role log: the loss at each global step
    (every 50th and the last), seconds per step, and where the queue
    engaged."""
    from datetime import datetime

    points, queue = [], None
    with open(log_path, errors="replace") as f:
        for line in f:
            m = SWAV_STEP.search(line)
            if m:
                t = datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S.%f")
                points.append((int(m.group(2)), float(m.group(3)), t.timestamp()))
            q = QUEUE.search(line)
            if q and queue is None:
                queue = int(q.group(1))
    if not points:
        return {"steps": 0}
    t0 = points[0][2]
    gaps = [(b[2] - a[2]) / max(b[0] - a[0], 1) for a, b in zip(points, points[1:])]
    return dict(
        steps=len(points), first_step=points[0][0], last_step=points[-1][0],
        first_loss=points[0][1], last_loss=points[-1][1],
        min_loss=min(p[1] for p in points), queue_engaged_at=queue,
        step_s_median=statistics.median(gaps) if gaps else None,
        wall_s=points[-1][2] - t0,
        finite=all(math.isfinite(p[1]) for p in points),
        at_step={str(s): dict(loss=l, wall_s=round(t - t0, 1))
                 for s, l, t in points[::50] + [points[-1]]})


def matched(log_a: str, log_b: str, every: int = 1) -> dict:
    """The MLM and total losses of two train logs at the global steps
    both logged, and the largest gap between them."""
    a = {r["step"]: r for r in _rows(log_a)}
    b = {r["step"]: r for r in _rows(log_b)}
    steps = sorted(set(a) & set(b))[::every]
    pairs = {str(s): dict(a_loss=a[s]["loss"], b_loss=b[s]["loss"],
                          a_mlm=a[s].get("mlm_loss"), b_mlm=b[s].get("mlm_loss"))
             for s in steps}
    gaps = [abs(a[s]["loss"] - b[s]["loss"]) for s in steps]
    return dict(steps=len(steps), max_abs_loss_gap=max(gaps) if gaps else None,
                mean_abs_loss_gap=statistics.mean(gaps) if gaps else None,
                at_step=pairs)


def monitor(run: str) -> None:
    from dedloc_tpu_torch.telemetry.watch import watch_rows

    rows = _rows(os.path.join(run, "train_log_tpu.jsonl"))
    if rows:
        r = rows[-1]
        print(f"card trainer: step {r['step']} loss {r['loss']:.4f} "
              f"{r['samples_per_second']:.1f} samples/s at {r['wall_s']:.0f} s")
    metrics = _rows(os.path.join(run, "coordinator_metrics.jsonl"))
    if metrics:
        watch = watch_rows(metrics)
        summary_ = watch.summary()
        verdict = summary_.get("verdict") or {}
        print(f"verdict: {verdict.get('status', '?')} "
              f"({verdict.get('reason', 'no health records seen')}), "
              f"{summary_['open']} open incident(s)")
    print(json.dumps(participation(run)))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("summary")
    s.add_argument("run")
    s.add_argument("--corpus", default=None)
    h = sub.add_parser("hashes")
    h.add_argument("run")
    h.add_argument("--watch", type=float, default=0.0)
    m = sub.add_parser("monitor")
    m.add_argument("run")
    w = sub.add_parser("swav")
    w.add_argument("log")
    t = sub.add_parser("matched")
    t.add_argument("log_a")
    t.add_argument("log_b")
    args = p.parse_args(argv)
    if args.cmd == "summary":
        print(json.dumps(summary(args.run, args.corpus)))
    elif args.cmd == "matched":
        print(json.dumps(matched(args.log_a, args.log_b)))
    elif args.cmd == "swav":
        print(json.dumps(swav_curve(args.log)))
    elif args.cmd == "hashes":
        print(json.dumps(watch_hashes(args.run, args.watch)))
    else:
        monitor(args.run)


if __name__ == "__main__":
    main()
