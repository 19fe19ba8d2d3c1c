"""Shared builders for role entry points: device, model, optimizer, DHT,
data.

Port of ``dedloc_tpu/roles/common.py``. The tensor-side builders run on the
card unless the caller names another device; the DHT, authorization,
checkpoint and telemetry builders are the JAX package's, over the port's
own copies of those modules.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from dedloc_tpu_torch.collaborative.metrics import make_validators
from dedloc_tpu_torch.core.config import CollaborationArguments, TrainingArguments
from dedloc_tpu_torch.data.mlm import SpecialTokens, mask_tokens, max_predictions_for
from dedloc_tpu_torch.models.albert import (
    AlbertConfig,
    AlbertForPreTraining,
    albert_pretraining_loss,
    albert_pretraining_loss_gathered,
    fused_ln_for_policy,
    init_weights,
)
from dedloc_tpu_torch.dht.dht import DHT
from dedloc_tpu_torch.optim.lamb import Lamb
from dedloc_tpu_torch.optim.schedules import linear_warmup_linear_decay
from dedloc_tpu_torch.utils.device import DeviceLike, resolve_device
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def force_cpu_if_requested() -> torch.device:
    """The device a role runs on: the CPU when the caller asks for it with
    ``DEDLOC_FORCE_CPU=1`` (multi-peer drives and tests), else the card —
    and without one that raises, as ``resolve_device`` does: a role never
    carries on quietly on the CPU."""
    if os.environ.get("DEDLOC_FORCE_CPU") == "1":
        return torch.device("cpu")
    return resolve_device(None)


def build_model(
    model_size: str,
    remat_policy: str = "",
    attention_impl: str = "",
    vocab_size: int = 0,
    device: DeviceLike = None,
    seed: int = 0,
    moe_experts: int = 0,
    moe_capacity_factor: float = 0.0,
    moe_aux_weight: float = -1.0,
) -> Tuple[AlbertConfig, AlbertForPreTraining]:
    """(config, model with random weights drawn from ``seed``) on ``device``
    (the card by default; ``"meta"`` gives shapes without storage). The MoE
    overrides apply as in the JAX builder; its mesh arguments come with the
    parallel-axes slice."""
    dev = resolve_device(device)
    overrides = {}
    if remat_policy:
        overrides["remat_policy"] = remat_policy
        overrides["fused_ln"] = fused_ln_for_policy(remat_policy)
    if attention_impl:
        overrides["attention_impl"] = attention_impl
    if vocab_size:
        overrides["vocab_size"] = vocab_size
    if moe_experts:
        overrides["moe_experts"] = moe_experts
        if moe_capacity_factor > 0:
            overrides["moe_capacity_factor"] = moe_capacity_factor
        if moe_aux_weight >= 0:
            overrides["moe_aux_weight"] = moe_aux_weight
    cfg = AlbertConfig.named(model_size)(**overrides)
    if dev.type == "meta":
        with torch.device("meta"):
            return cfg, AlbertForPreTraining(cfg)
    model = AlbertForPreTraining(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return cfg, model.to(dev)


def single_device_attention_impl(impl: str) -> str:
    """Attention impl for single-device roles (evaluate): 'ring' needs the
    trainer's sequence-parallel mesh, but every impl is exact and shares
    one param tree, so it degrades to 'dense' outside the trainer."""
    return "dense" if impl == "ring" else impl


def _training(args) -> TrainingArguments:
    return args.training if isinstance(args, CollaborationArguments) else args


def _schedule(tr: TrainingArguments):
    return linear_warmup_linear_decay(
        tr.learning_rate, warmup_steps=tr.warmup_steps,
        total_steps=tr.total_steps,
    )


def build_optimizer(args) -> Lamb:
    """LAMB + linear warmup/decay (reference recipe), from the collaboration
    arguments as in the JAX package, or from their ``training`` part."""
    tr = _training(args)
    return Lamb(
        learning_rate=_schedule(tr),
        weight_decay=tr.weight_decay,
        clamp_value=tr.clamp_value,
        max_grad_norm=tr.max_grad_norm,
    )


def build_flat_opt_factory(args) -> Callable:
    """(spec, params) -> ``optim.flat.FlatLamb`` for the SAME
    hyperparameters as ``build_optimizer``: the flat apply's twin of the
    per-leaf chain (--optimizer.flat_apply). A factory, because the wire
    spec only exists once the first gradient dict does."""
    tr = _training(args)
    schedule = _schedule(tr)

    def factory(spec, params):
        from dedloc_tpu_torch.optim.flat import FlatLamb, tree_flags
        from dedloc_tpu_torch.optim.lamb import albert_weight_decay_mask

        flags = tree_flags(albert_weight_decay_mask(params), params,
                           [name for name, _shape, _dtype in spec])
        return FlatLamb(
            spec, flags, schedule,
            weight_decay=tr.weight_decay,
            clamp_value=tr.clamp_value,
            max_grad_norm=tr.max_grad_norm,
        )

    return factory


def build_authorizer(args: CollaborationArguments):
    """Gated-run handshake: when --auth.username is set, fetch a signed
    access token from the AuthService (default host: the first initial
    peer, where the coordinator attaches it) and return (authorizer,
    authority_public_key); (None, None) for open runs."""
    if not args.auth.username:
        return None, None
    spec = args.auth.endpoint or (
        args.dht.initial_peers[0] if args.dht.initial_peers else ""
    )
    if not spec:
        raise ValueError(
            "--auth.username given but no --auth.endpoint and no "
            "--dht.initial_peers to default to"
        )
    host, _, port = spec.rpartition(":")
    from dedloc_tpu_torch.core.auth import remote_auth_handshake

    authorizer = remote_auth_handshake(
        (host, int(port)), args.auth.username, args.auth.credential
    )
    from dedloc_tpu_torch.core.timeutils import get_dht_time

    remaining = authorizer._token.expiration_time - get_dht_time()
    logger.info(
        f"authorized as {args.auth.username!r} "
        f"(token valid for {remaining:.0f}s; auto-refreshes)"
    )
    return authorizer, authorizer.authority_public_key


def build_dht(
    args: CollaborationArguments,
    client_mode: Optional[bool] = None,
    private_key=None,
):
    """DHT with the signed-metrics validator chain. Returns (dht, subkey).

    ``private_key`` lets a gated peer sign DHT records with its TOKEN key
    (``authorizer.local_private_key``), so contribution-ledger records are
    identity-bound end to end; open runs leave it None and get a fresh
    per-process key."""
    validators, public_key = make_validators(
        args.dht.experiment_prefix, private_key
    )
    dht = DHT(
        initial_peers=args.dht.initial_peers,
        start=True,
        listen_host=args.dht.listen_host,
        listen_port=args.dht.listen_port,
        client_mode=args.dht.client_mode if client_mode is None else client_mode,
        record_validators=validators,
        advertised_host=args.dht.advertised_host or None,
    )
    return dht, public_key


def checkpoint_kwargs(args, public_key: bytes) -> Dict:
    """Resolve ``--checkpoint.*`` knobs into CollaborativeOptimizer kwargs.
    THE one resolution point for the shard cache dir: empty =
    ``<output_dir>/shard_cache``, "none" = no cache."""
    ck = args.checkpoint
    if ck.cache_dir == "none":
        cache_dir = None
    else:
        cache_dir = ck.cache_dir or os.path.join(
            args.training.output_dir, "shard_cache"
        )
    return dict(
        checkpoint_shard_size=ck.shard_size,
        checkpoint_fetch_parallelism=ck.fetch_parallelism,
        checkpoint_max_providers=ck.providers,
        checkpoint_dir=cache_dir,
        # catalog announcements ride the peer's SIGNED metrics subkey
        signed_subkey=public_key,
    )


def configure_role_telemetry(args, public_key: bytes):
    """Install the process-global swarm-telemetry registry for a role
    (``--telemetry.*``). The peer label is the sha1 fingerprint of the
    signed metrics subkey, as the JAX package derives it. Returns
    ``(registry_or_None, close_fn)``; call ``close_fn()`` on shutdown."""
    import hashlib

    from dedloc_tpu_torch import telemetry

    tele = telemetry.configure(
        args.telemetry, peer=hashlib.sha1(public_key).hexdigest()[:12]
    )

    def close() -> None:
        if tele is not None:
            tele.close()
            telemetry.uninstall(tele)

    return tele, close


def build_loss_fn(model: AlbertForPreTraining) -> Callable:
    """``loss_fn(params, batch, rng) -> (loss, metrics)``, the model applied
    with ``params`` (a name -> tensor dict). Gathered masked-position loss
    when the batch carries ``mlm_positions``; dense per-position otherwise.
    With an MoE config the Switch load-balancing aux loss is added at
    ``cfg.moe_aux_weight`` and reported as ``moe_aux``. ``rng`` is accepted
    for the JAX signature: the recipe has no dropout."""
    moe = model.cfg.moe_experts > 0

    def loss_fn(params, batch, rng: Optional[torch.Generator] = None):
        gathered = "mlm_positions" in batch
        losses = {}
        mlm_logits, sop_logits = functional_call(
            model, params,
            (batch["input_ids"], batch["attention_mask"], batch["token_type_ids"]),
            {"mlm_positions": batch["mlm_positions"] if gathered else None,
             "losses": losses},
        )
        if gathered:
            loss, metrics = albert_pretraining_loss_gathered(
                mlm_logits, sop_logits, batch["mlm_label_ids"],
                batch["mlm_weights"], batch["sop_labels"],
            )
        else:
            loss, metrics = albert_pretraining_loss(
                mlm_logits, sop_logits, batch["mlm_labels"], batch["sop_labels"]
            )
        if moe:
            aux = losses["moe_aux"]
            loss = loss + model.cfg.moe_aux_weight * aux
            metrics = dict(metrics, moe_aux=aux)
        return loss, metrics

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
