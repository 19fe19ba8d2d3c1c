"""Serving gateway: the swarm-facing front door for MoE inference.

A gateway joins the DHT like any peer, keeps an ``ExpertRouter`` warm
against the ``{prefix}_experts`` directory, and exposes one RPC —
``gateway.infer`` — that gates a token batch locally (top-1 Switch
routing over shipped router weights) and fans the per-expert groups out
to the hosting peers, combining gate-weighted outputs with the residual
fall-through for anything the swarm could not serve in time. It is the
deployment shape of ROADMAP item 1: the training swarm doubling as a
serving fleet, fronted by as many stateless gateways as traffic needs.

Run: ``python -m dedloc_tpu_torch.roles.gateway --dht.initial_peers host:port
--serving.request_deadline 2.0`` (all ``--serving.*`` knobs in
core/config.py; routing policy in docs/serving.md).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from dedloc_tpu_torch.core.config import CollaborationArguments, parse_config
from dedloc_tpu_torch.core.serialization import (
    CompressionType,
    deserialize_array,
    serialize_array,
)
from dedloc_tpu_torch.roles.common import build_dht
from dedloc_tpu_torch.serving.router import ExpertRouter, RouterPolicy
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def policy_from_args(args: CollaborationArguments) -> RouterPolicy:
    """--serving.* flags -> the router's dispatch policy (ONE resolution
    point, so role and tests cannot drift)."""
    s = args.serving
    return RouterPolicy(
        deadline_s=float(s.request_deadline),
        attempt_timeout_s=float(s.attempt_timeout),
        retries=int(s.retries),
        backoff_s=float(s.backoff),
        hedge_after_s=float(s.hedge_after),
        refresh_period_s=float(s.refresh_period),
    )


class GatewayService:
    """The embeddable gateway: an ``ExpertRouter`` plus the
    ``gateway.infer`` RPC surface, attachable to any DHTNode (the role
    below and the simulator's serving scenario both use it)."""

    def __init__(
        self,
        node,
        prefix: str,
        policy: Optional[RouterPolicy] = None,
        router_params: Optional[np.ndarray] = None,
        version: Optional[int] = None,
        telemetry_registry=None,
    ):
        self.router = ExpertRouter(
            node, prefix, policy=policy, telemetry_registry=telemetry_registry
        )
        self.router_params = router_params
        self.version = version
        node.server.register("gateway.infer", self._rpc_infer)

    async def _rpc_infer(self, peer, args):
        """One inference request: gate + swarm fan-out + combine."""
        if self.router_params is None:
            raise RuntimeError("gateway has no router weights loaded")
        x = deserialize_array(args["tokens"])
        request_id = str(args.get("request_id") or "req")
        y, stats = await self.router.infer(
            self.router_params, x, request_id, version=self.version
        )
        return {
            "data": serialize_array(
                np.ascontiguousarray(y, dtype=np.float32),
                CompressionType.NONE,
            ),
            **stats,
        }


def run_gateway(
    args: CollaborationArguments,
    router_params: Optional[np.ndarray] = None,
    poll_period: float = 5.0,
    max_iterations: int = 0,
) -> None:
    """Role entry point: DHT (full peer — the gateway must be dialable to
    host ``gateway.infer``), router, refresh loop."""
    dht, _ = build_dht(args, client_mode=False)
    prefix = args.dht.experiment_prefix
    policy = policy_from_args(args)
    service_box = {}

    async def _attach(node):
        service_box["service"] = GatewayService(
            node, prefix, policy=policy, router_params=router_params,
        )
        await service_box["service"].router.refresh(force=True)
        return service_box["service"].router.known_experts()

    known = dht.run_coroutine(lambda node: _attach(node))
    logger.info(
        f"gateway up at {dht.get_visible_address()} "
        f"(experts known at boot: {known})"
    )
    iterations = 0
    try:
        while True:
            known = dht.run_coroutine(
                lambda node: _refresh(service_box["service"].router)
            )
            logger.info(f"gateway directory: {len(known)} experts live")
            iterations += 1
            if max_iterations and iterations >= max_iterations:
                break
            time.sleep(poll_period)
    finally:
        dht.shutdown()


async def _refresh(router: ExpertRouter):
    await router.refresh(force=True)
    return router.known_experts()


def main(argv=None) -> None:
    run_gateway(parse_config(CollaborationArguments, argv))


if __name__ == "__main__":
    main()
