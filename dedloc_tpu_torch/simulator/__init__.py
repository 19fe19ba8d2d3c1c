"""Discrete-event swarm simulator: 1,000-peer runs in one process.

Layers (docs/simulator.md):

- ``engine``    — a virtual-time asyncio event loop riding the seeded
  ``testing/faults.py`` FakeClock: no real sleeps, deterministic
  same-timestamp ordering.
- ``network``   — per-directed-link latency/bandwidth/loss models with
  serialized-uplink contention, behind the ``dht/transport.py`` seam.
- ``swarm``     — spawn N full peers (DHT node, matchmaker, optional
  checkpoint-catalog announcer) in one process with component-scoped
  telemetry registries.
- ``scenarios`` — named, JSON-configurable scenarios + the sizing report
  ``tools/swarm_sim.py`` emits.
"""
from dedloc_tpu_torch.simulator.engine import SimEngine
from dedloc_tpu_torch.simulator.network import LinkSpec, SimNetwork, SimTransport
from dedloc_tpu_torch.simulator.swarm import SimPeer, SimSwarm

__all__ = [
    "SimEngine",
    "LinkSpec",
    "SimNetwork",
    "SimTransport",
    "SimPeer",
    "SimSwarm",
]
