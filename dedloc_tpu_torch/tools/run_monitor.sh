#!/bin/bash
# One-screen health check for a live dedloc_tpu_torch/tools/hetero_converge.sh
# run (the counterpart of tools/run_monitor.sh):
#   bash dedloc_tpu_torch/tools/run_monitor.sh /path/run
#
# The health logic lives in the port's copy of the watchdog
# (dedloc_tpu_torch/telemetry/watch.py, the one the coordinator runs
# inline): the shared OK/DEGRADED verdict plus any OPEN incidents from the
# coordinator metrics JSONL; the card trainer's cadence and loss from its
# train log. This script only assembles the screen.
set -u
RUN=${1:?usage: run_monitor.sh RUN_DIR}
REPO=$(cd "$(dirname "$0")/../.." && pwd)
echo "=== $(date +%T) $RUN ==="
tail -2 "$RUN/orchestrator.log" 2>/dev/null
PYTHONPATH="$REPO" python -m dedloc_tpu_torch.tools.sustained monitor "$RUN" 2>/dev/null
pgrep -fc "dedloc_tpu_torch.roles" | xargs echo "live role processes:"
