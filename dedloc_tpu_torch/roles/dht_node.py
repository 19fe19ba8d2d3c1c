"""Initial DHT bootstrap node.

Capability parity with swav/run_initial_dht_node.py:35-40: a standalone DHT
peer that other peers use as ``initial_peers``; a keepalive loop issues a
random get every 30 s so the node notices (and prunes) dead neighbours.
"""
from __future__ import annotations

import time
import uuid

from dedloc_tpu_torch.core.config import CollaborationArguments, parse_config
from dedloc_tpu_torch.roles.common import build_dht
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def run_dht_node(
    args: CollaborationArguments,
    keepalive_period: float = 30.0,
    max_iterations: int = 0,
) -> None:
    dht, _ = build_dht(args, client_mode=False)
    logger.info(
        f"initial DHT node up at {dht.get_visible_address()} "
        f"(bootstrap with --dht.initial_peers host:{dht.port})"
    )
    iterations = 0
    try:
        while True:
            dht.get(uuid.uuid4().hex)  # keepalive (run_initial_dht_node.py:39)
            iterations += 1
            if max_iterations and iterations >= max_iterations:
                break
            time.sleep(keepalive_period)
    finally:
        dht.shutdown()


def main(argv=None) -> None:
    run_dht_node(parse_config(CollaborationArguments, argv))


if __name__ == "__main__":
    main()
