"""Auxiliary peer: donates bandwidth to averaging, contributes no gradients.

Port of ``dedloc_tpu/roles/aux.py`` (capability parity with
albert/run_aux.py:206-263): a CPU peer that joins averaging groups with
zero weight every 0.5 s (``CollaborativeOptimizer(auxiliary=True,
allow_state_sharing=False)`` + ``step_aux()`` loop). It hosts
bandwidth-weighted spans during the group reduce-scatter, which speeds up
rounds for slow trainer peers. It holds no tensor on a device: the
gradient template is numpy, in the wire's (JAX) names and layout, so the
role resolves no device and starts on a machine without a card.
"""
from __future__ import annotations

import time

import numpy as np

from dedloc_tpu_torch.collaborative.optimizer import CollaborativeOptimizer
from dedloc_tpu_torch.core.config import CollaborationArguments, parse_config
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.roles.common import (
    build_authorizer,
    build_dht,
    build_model,
    build_optimizer,
    configure_role_telemetry,
    single_device_attention_impl,
)
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _local_template(args: CollaborationArguments):
    """Gradient shapes from the local model config — the offline fallback
    when no state provider is live yet (shape-only: the model is built on
    the meta device). Names and shapes are the wire's, the JAX trainer's
    (``models/convert.py`` ``grad_name``), never torch's ``[out, in]``.
    The MoE flags shape the template as they shape the trainer's model."""
    tr = args.training
    _cfg, model = build_model(
        tr.model_size,
        tr.remat_policy,
        single_device_attention_impl(tr.attention_impl),
        tr.vocab_size,
        device="meta",
        moe_experts=tr.moe_experts,
        moe_capacity_factor=tr.moe_capacity_factor,
        moe_aux_weight=tr.moe_aux_weight,
    )
    template = {}
    for name, p in model.named_parameters():
        wire, perm = convert.grad_name(name, p.ndim)
        template[wire] = np.zeros(convert.to_jax_layout(p, perm).shape, np.float32)
    return template


def run_aux(
    args: CollaborationArguments,
    poll_interval: float = 0.5,
    max_iterations: int = 0,
    max_rounds: int = 0,
) -> int:
    """Returns the number of averaging rounds joined (for tests).

    The gradient-shape template SELF-BOOTSTRAPS from a live state provider
    (run_aux.py:243-263 capability: the aux learns the model from the
    collaboration, not from the caller); the local model config is only the
    fallback while nobody shares state yet.

    The loop runs until stopped, or (each when nonzero) for
    ``max_iterations`` polls or until it has joined ``max_rounds`` rounds.
    A poll that finds no round ready returns at once, so ``max_iterations``
    polls last about ``max_iterations * poll_interval`` seconds."""
    # gated runs: aux peers need envelopes too (leaders reject unsigned
    # joins; gated joiners reject unsigned leader replies)
    authorizer, authority_public_key = build_authorizer(args)
    tx = build_optimizer(args)
    # gated: record-sign with the token key, so the signed subkey digests
    # to this peer's verified identity (ledger binding, roles/common.py)
    dht, public_key = build_dht(
        args,
        private_key=(
            authorizer.local_private_key if authorizer is not None else None
        ),
    )
    logger.info(f"aux peer DHT listening on {dht.port}")
    # swarm telemetry (--telemetry.*): an aux donor's join failures and
    # allreduce stragglers are the events operators need when a donor
    # silently loses every matchmaking race
    _tele, tele_close = configure_role_telemetry(args, public_key)
    opt = CollaborativeOptimizer(
        tx,
        dht,
        prefix=args.dht.experiment_prefix,
        target_batch_size=args.optimizer.target_batch_size,
        batch_size_lead=args.optimizer.batch_size_lead,
        bandwidth=args.averager.bandwidth,
        compression=args.averager.compression,
        chunk_size=args.averager.chunk_size,
        # the whole swarm must share one hierarchy: an aux donor without
        # the plan would advertise into the flat scope nobody else forms
        topology_plan=args.averager.topology_plan or None,
        # and it must follow live re-plans for the same reason (unless the
        # operator pinned a manual plan)
        plan_follow=(
            args.averager.plan_follow and not args.averager.topology_plan
        ),
        plan_refresh_period=args.averager.plan_refresh_period,
        target_group_size=args.averager.target_group_size,
        averaging_expiration=args.averager.averaging_expiration,
        averaging_timeout=args.averager.averaging_timeout,
        listen_port=args.averager.listen_port,
        auxiliary=True,
        advertised_host=args.dht.advertised_host or None,
        allow_state_sharing=False,
        authorizer=authorizer,
        authority_public_key=authority_public_key,
        verbose=True,
    )
    rounds = iterations = 0
    template = fallback = None
    try:
        while True:
            if template is None:
                # self-bootstrap keeps retrying until a provider appears —
                # a late-started aux needs no model knowledge at all
                template = opt.bootstrap_aux_template(timeout=10.0)
                if template is not None:
                    logger.info(
                        f"bootstrapped gradient template from a state "
                        f"provider ({len(template)} tensors)"
                    )
            current = template
            if current is None:
                # nobody shares state yet: derive shapes locally so the
                # collaboration's very first rounds still get bandwidth
                if fallback is None:
                    fallback = _local_template(args)
                    logger.info(
                        "no state provider yet; using local model shapes"
                    )
                current = fallback
            if opt.step_aux(current):
                rounds += 1
                logger.info(f"joined averaging round (total {rounds})")
            iterations += 1
            if max_iterations and iterations >= max_iterations:
                break
            if max_rounds and rounds >= max_rounds:
                break
            time.sleep(poll_interval)
    finally:
        tele_close()
        opt.shutdown()
        dht.shutdown()
    return rounds


def main(argv=None) -> None:
    run_aux(parse_config(CollaborationArguments, argv))


if __name__ == "__main__":
    main()
