"""Telemetry-replay digital twin (ROADMAP item 4).

``fit.py`` fits the simulator's network/compute model from a real run's
telemetry; ``replay.py`` replays the recorded workload over the fitted
model in virtual time and scores twin fidelity. ``tools/twin_sweep.py``
sweeps configurations over a fitted model; ``tools/runlog_summary.py
--twin`` renders the fidelity report.
"""
from dedloc_tpu_torch.twin.fit import TwinModel, fit_twin
from dedloc_tpu_torch.twin.replay import fidelity_report, replay_twin

__all__ = ["TwinModel", "fit_twin", "fidelity_report", "replay_twin"]
