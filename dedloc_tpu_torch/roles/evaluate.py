"""Held-out evaluation: MLM+SOP loss of a checkpoint over a tokenized set.

Port of ``dedloc_tpu/roles/evaluate.py``: the masked-LM cross-entropy (and
perplexity) and the sentence-order loss of a checkpoint on held-out shards
(``data/disk.py``), printed as one JSON line with the JAX role's keys. A
checkpoint of either package's trainer loads (the params of the
``(params, opt_state)`` pair, or bare params). It runs on the card unless
``DEDLOC_FORCE_CPU=1`` asks for the CPU.

Run:
    python -m dedloc_tpu_torch.roles.evaluate \\
        --training.dataset_path data/holdout_tokenized \\
        --training.output_dir outputs  # newest checkpoint-<step> wins \\
        --eval.max_batches 50

Deterministic: the batches and their masks come from the numpy seed
(``--training.seed``) and the model runs without dropout, so two
evaluations of the same checkpoint give the same numbers.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np
import torch

from dedloc_tpu_torch.core.config import CollaborationArguments, parse_config
from dedloc_tpu_torch.models.convert import params_from_checkpoint
from dedloc_tpu_torch.roles.common import (
    build_loss_fn,
    build_model,
    drop_collator_keys,
    force_cpu_if_requested,
    single_device_attention_impl,
)
from dedloc_tpu_torch.utils.checkpoint import load_latest_checkpoint
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class EvalArguments:
    max_batches: int = 50
    checkpoint_path: str = ""  # explicit checkpoint dir; empty = newest in
    # training.output_dir (or fresh init when none exists — smoke mode)


@dataclass
class EvalCLIArguments(CollaborationArguments):
    eval: EvalArguments = field(default_factory=EvalArguments)


def run_eval(args: CollaborationArguments,
             extra: EvalArguments) -> dict:
    device = force_cpu_if_requested()
    impl = single_device_attention_impl(args.training.attention_impl)
    cfg, model = build_model(
        args.training.model_size,
        args.training.remat_policy,
        impl,
        args.training.vocab_size,
        device=device,
    )
    if not args.training.dataset_path:
        raise ValueError("--training.dataset_path: a tokenized dir is required")

    seq = min(args.training.seq_length, cfg.max_position_embeddings)
    step = 0
    if extra.checkpoint_path:
        from dedloc_tpu_torch.utils.checkpoint import load_checkpoint

        tree, meta = load_checkpoint(extra.checkpoint_path)
        step = int(meta.get("local_step", meta.get("step", 0)))
        _restore(model, tree)
    else:
        resumed = load_latest_checkpoint(args.training.output_dir)
        if resumed is not None:
            step, tree, _meta = resumed
            _restore(model, tree)
        else:
            logger.warning("no checkpoint found; evaluating a fresh init")

    loss_fn = build_loss_fn(model)
    params = dict(model.named_parameters())
    model.eval()

    from dedloc_tpu_torch.data.disk import tokenized_dataset_batches

    batches = tokenized_dataset_batches(
        args.training.dataset_path, cfg,
        args.training.per_device_batch_size, seq, seed=args.training.seed,
    )
    total_mlm = total_sop = 0.0
    n = 0
    with torch.no_grad():
        for _ in range(extra.max_batches):
            batch = drop_collator_keys(next(batches), device=device)
            _loss, metrics = loss_fn(params, batch)
            total_mlm += float(metrics.get("mlm_loss", metrics["loss"]))
            total_sop += float(metrics.get("sop_loss", 0.0))
            n += 1
    mean_mlm = total_mlm / max(n, 1)
    result = {
        "checkpoint_step": step,
        "eval_batches": n,
        "mlm_loss": mean_mlm,
        # fp32, as the JAX role's jnp.exp
        "mlm_perplexity": float(np.exp(np.float32(mean_mlm))),
        "sop_loss": total_sop / max(n, 1),
    }
    print(json.dumps(result))
    return result


def _restore(model: torch.nn.Module, tree) -> None:
    """Load a checkpoint tree's params into ``model``: the trainer's
    (params, opt_state) named leaves or bare params, every leaf required."""
    model.load_state_dict(params_from_checkpoint(tree))


def main(argv=None) -> None:
    args = parse_config(EvalCLIArguments, argv)
    run_eval(args, args.eval)


if __name__ == "__main__":
    main()
