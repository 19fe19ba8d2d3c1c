"""One-command volunteer onboarding: ``python -m dedloc_tpu_torch.join``.

The executable equivalent of the reference's contributor notebook
(sahajbert/contributor_notebook.ipynb, 4 cells: install → authorize → join
DHT → train). Everything the notebook does interactively happens here from
one command:

    python -m dedloc_tpu_torch.join \\
        --initial_peers COORD_HOST:31337 \\
        --experiment_prefix THE_RUN_NAME \\
        --username alice --credential s3cret

1. **authorize** (gated runs): fetches a signed access token from the
   coordinator's AuthService, failing fast on bad credentials (cell 2).
2. **join**: connects to the DHT via any live peer, downloads the newest
   model+optimizer state from the collaboration (cell 3's
   ``load_state_from_peers`` — no checkpoint files needed).
3. **train**: accumulates gradients and participates in group averaging
   until interrupted; leaving at any time only costs the current group one
   round (cell 3's butterfly-averaging prose).

Open runs omit ``--username``. Firewalled volunteers add ``--client_mode``
(and optionally ``--relay HOST:PORT``); NAT traversal upgrades their
connections to direct paths automatically (docs/transport.md). Any advanced
dotted flag of the full trainer surface can be appended verbatim, e.g.
``--training.per_device_batch_size 8``.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def build_trainer_argv(argv: Optional[List[str]] = None) -> List[str]:
    """Map the friendly flag surface onto the trainer's dotted config tree;
    unknown (dotted) flags pass through untouched."""
    parser = argparse.ArgumentParser(
        prog="python -m dedloc_tpu_torch.join",
        description="Join a collaborative training run as a volunteer peer.",
    )
    parser.add_argument("--initial_peers", required=True,
                        help="host:port of any live peer (comma-separated)")
    parser.add_argument("--experiment_prefix", required=True,
                        help="the run's name (ask the organizers)")
    parser.add_argument("--username", default="",
                        help="allowlisted username (gated runs only)")
    parser.add_argument("--credential", default="",
                        help="access credential for --username")
    parser.add_argument("--auth_endpoint", default="",
                        help="host:port of the AuthService "
                             "(default: the first initial peer)")
    parser.add_argument("--client_mode", action="store_true",
                        help="outbound-only (behind a firewall/NAT)")
    parser.add_argument("--relay", default="",
                        help="host:port of a public peer's relay")
    parser.add_argument("--batch_size", type=int, default=4,
                        help="per-device micro-batch size")
    known, passthrough = parser.parse_known_args(argv)

    # the trainer's list flags are space-separated (nargs="*"); the friendly
    # surface documents comma-separated, so split here
    peers = [p for p in known.initial_peers.split(",") if p]
    trainer_argv = [
        "--dht.initial_peers", *peers,
        "--dht.experiment_prefix", known.experiment_prefix,
        "--training.per_device_batch_size", str(known.batch_size),
    ]
    if known.username:
        trainer_argv += ["--auth.username", known.username,
                         "--auth.credential", known.credential]
    if known.auth_endpoint:
        trainer_argv += ["--auth.endpoint", known.auth_endpoint]
    if known.client_mode:
        trainer_argv += ["--dht.client_mode", "true"]
    if known.relay:
        trainer_argv += ["--dht.relay", known.relay]
    return trainer_argv + passthrough


def main(argv: Optional[List[str]] = None) -> None:
    from dedloc_tpu_torch.core.config import CollaborationArguments, parse_config
    from dedloc_tpu_torch.roles.trainer import run_trainer

    args = parse_config(CollaborationArguments, build_trainer_argv(argv))
    state = run_trainer(args)
    print(f"left the collaboration at global step {int(state.step)}")


if __name__ == "__main__":
    main()
