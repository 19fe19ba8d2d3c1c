"""Builders for the trainer peer's device path: model, optimizer, loss, data.

Port of the tensor-side builders of ``dedloc_tpu/roles/common.py``. The DHT,
authorization, checkpoint and telemetry builders come with the slices that
port the collaboration itself.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from dedloc_tpu_torch.core.config import TrainingArguments
from dedloc_tpu_torch.data.mlm import SpecialTokens, mask_tokens, max_predictions_for
from dedloc_tpu_torch.models.albert import (
    AlbertConfig,
    AlbertForPreTraining,
    albert_pretraining_loss,
    albert_pretraining_loss_gathered,
    fused_ln_for_policy,
    init_weights,
)
from dedloc_tpu_torch.optim.lamb import Lamb
from dedloc_tpu_torch.optim.schedules import linear_warmup_linear_decay
from dedloc_tpu_torch.utils.device import DeviceLike, resolve_device


def build_model(
    model_size: str,
    remat_policy: str = "",
    attention_impl: str = "",
    vocab_size: int = 0,
    device: DeviceLike = None,
    seed: int = 0,
) -> Tuple[AlbertConfig, AlbertForPreTraining]:
    """(config, model with random weights drawn from ``seed``) on ``device``
    (the card by default). The JAX builder's mesh and MoE arguments come
    with the slices that port them."""
    dev = resolve_device(device)
    overrides = {}
    if remat_policy:
        overrides["remat_policy"] = remat_policy
        overrides["fused_ln"] = fused_ln_for_policy(remat_policy)
    if attention_impl:
        overrides["attention_impl"] = attention_impl
    if vocab_size:
        overrides["vocab_size"] = vocab_size
    cfg = AlbertConfig.named(model_size)(**overrides)
    model = AlbertForPreTraining(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return cfg, model.to(dev)


def build_optimizer(args: TrainingArguments) -> Lamb:
    """LAMB + linear warmup/decay (reference recipe). Takes the training
    arguments (the JAX builder reads the same fields from ``args.training``)."""
    schedule = linear_warmup_linear_decay(
        args.learning_rate,
        warmup_steps=args.warmup_steps,
        total_steps=args.total_steps,
    )
    return Lamb(
        learning_rate=schedule,
        weight_decay=args.weight_decay,
        clamp_value=args.clamp_value,
        max_grad_norm=args.max_grad_norm,
    )


def build_loss_fn(model: AlbertForPreTraining) -> Callable:
    """``loss_fn(params, batch, rng) -> (loss, metrics)``, the model applied
    with ``params`` (a name -> tensor dict). Gathered masked-position loss
    when the batch carries ``mlm_positions``; dense per-position otherwise.
    ``rng`` is accepted for the JAX signature: the recipe has no dropout."""

    def loss_fn(params, batch, rng: Optional[torch.Generator] = None):
        gathered = "mlm_positions" in batch
        mlm_logits, sop_logits = functional_call(
            model, params,
            (batch["input_ids"], batch["attention_mask"], batch["token_type_ids"]),
            {"mlm_positions": batch["mlm_positions"] if gathered else None},
        )
        if gathered:
            return albert_pretraining_loss_gathered(
                mlm_logits, sop_logits, batch["mlm_label_ids"],
                batch["mlm_weights"], batch["sop_labels"],
            )
        return albert_pretraining_loss(
            mlm_logits, sop_logits, batch["mlm_labels"], batch["sop_labels"]
        )

    return loss_fn


def synthetic_mlm_batches(
    cfg: AlbertConfig,
    batch_size: int,
    seq_length: int,
    seed: int,
) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic fixture stream: random token documents, real masking path.
    Deterministic per seed (numpy, the same stream as the JAX package's)."""
    rng = np.random.default_rng(seed)
    tokens = SpecialTokens(vocab_size=cfg.vocab_size)
    seq_length = min(seq_length, cfg.max_position_embeddings)
    max_predictions = max_predictions_for(seq_length)
    while True:
        ids = rng.integers(
            tokens.num_reserved, cfg.vocab_size, (batch_size, seq_length)
        ).astype(np.int32)
        batch = {
            "input_ids": ids,
            "attention_mask": np.ones((batch_size, seq_length), np.int32),
            "token_type_ids": np.zeros((batch_size, seq_length), np.int32),
            "special_tokens_mask": np.zeros((batch_size, seq_length), np.int32),
            "sop_labels": rng.integers(0, 2, (batch_size,)).astype(np.int32),
        }
        yield mask_tokens(batch, rng, tokens, max_predictions=max_predictions)


def drop_collator_keys(
    batch: Dict[str, np.ndarray], device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """Keep only what the loss consumes, as tensors on ``device`` (the card
    by default)."""
    dev = resolve_device(device)
    if "mlm_positions" in batch:
        keep = ("input_ids", "attention_mask", "token_type_ids",
                "mlm_positions", "mlm_label_ids", "mlm_weights", "sop_labels")
    else:
        keep = ("input_ids", "attention_mask", "token_type_ids",
                "mlm_labels", "sop_labels")
    return {k: torch.as_tensor(batch[k]).to(dev) for k in keep}
