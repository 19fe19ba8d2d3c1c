#!/bin/bash
# SwAV multi-peer run on mixed hardware in one host over the port's roles
# (python -m dedloc_tpu_torch.roles.*), the counterpart of
# tools/swav_hetero.sh: the card as one SwAV trainer peer (ResNet-50
# multicrop, queue engaged) plus a slow CPU SwAV volunteer, an aux
# bandwidth donor (gradient template self-bootstrapped from the card
# peer's shared state) and the coordinator; one SIGKILL/rejoin churn event
# mid-run. The vision-side counterpart of hetero_converge.sh.
#
# Usage:
#   python -m dedloc_tpu_torch.tools.swav_probe generate --out $CORPUS/swav_images
#   CORPUS=/path/corpus RUN=/path/swav TOTAL=4800 CHURN=2400 REJOIN=300 \
#     bash dedloc_tpu_torch/tools/swav_hetero.sh
#
# The card peer takes the card; the volunteer runs on the CPU because
# DEDLOC_FORCE_CPU=1 asks for it; the coordinator and the aux start with
# CUDA hidden. tools/swav_hetero.sh's JAX_COMPILATION_CACHE_DIR and
# JAX_PLATFORMS=cpu have no counterpart: PyTorch runs eagerly (nothing to
# compile and cache) and the device is chosen by DEDLOC_FORCE_CPU.
set -u
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
CORPUS=${CORPUS:?set CORPUS to the directory holding swav_images}
RUN=${RUN:-$CORPUS/r5_swav}
PREFIX=${PREFIX:-swav5}
PORT=${PORT:-42000}
CARD_AVG_PORT=${CARD_AVG_PORT:-42011}
WINDOW=${WINDOW:-30}
TARGET=${TARGET:-16}           # solo recipe scale (r4 sustained run)
TOTAL=${TOTAL:-4800}
CHURN=${CHURN:-2400}
REJOIN=${REJOIN:-300}
SAVE_STEPS=${SAVE_STEPS:-50}
QUEUE_START=${QUEUE_START:-400}
VOL_THREADS=${VOL_THREADS:-2}  # torch threads of the CPU volunteer
mkdir -p "$RUN"

COMMON="--dht.experiment_prefix $PREFIX --optimizer.target_batch_size $TARGET \
  --averager.averaging_expiration $WINDOW --averager.averaging_timeout 180 \
  --training.learning_rate 0.15 --training.warmup_steps 200 \
  --training.total_steps 2500 \
  --training.queue_length 3840 --training.queue_start_step $QUEUE_START"

log() { echo "[orc] $(date +%T) $*" | tee -a "$RUN/orchestrator.log"; }

log "coordinator up"
python -m dedloc_tpu_torch.roles.coordinator \
  --dht.experiment_prefix "$PREFIX" --dht.listen_port "$PORT" \
  --coordinator.refresh_period 20 --coordinator.upload_interval 0 \
  --coordinator.metrics_log_path "$RUN/coordinator_metrics.jsonl" \
  > "$RUN/coordinator.log" 2>&1 &
COORD=$!
sleep 8

log "card swav peer up (ResNet-50 multicrop, queue from step $QUEUE_START)"
python -m dedloc_tpu_torch.roles.swav $COMMON \
  --dht.initial_peers 127.0.0.1:"$PORT" \
  --averager.listen_port "$CARD_AVG_PORT" \
  --training.image_folder "$CORPUS/swav_images" \
  --training.per_device_batch_size 16 \
  --training.save_steps "$SAVE_STEPS" \
  --training.output_dir "$RUN/outputs" --training.seed 0 \
  > "$RUN/swav_tpu.log" 2>&1 &
CARD=$!
sleep 10

log "aux up (template self-bootstraps from the card peer's shared state)"
nice -n 19 python -m dedloc_tpu_torch.roles.aux \
  --dht.experiment_prefix "$PREFIX" --dht.initial_peers 127.0.0.1:"$PORT" \
  --optimizer.target_batch_size "$TARGET" \
  --averager.averaging_expiration "$WINDOW" --averager.averaging_timeout 180 \
  > "$RUN/aux.log" 2>&1 &
AUX=$!
sleep 20

cpu_volunteer() {
  # slow vision volunteer: same ResNet-50 param schema, small batch
  DEDLOC_FORCE_CPU=1 OMP_NUM_THREADS="$VOL_THREADS" nice -n 19 \
    python -m dedloc_tpu_torch.roles.swav $COMMON \
    --dht.initial_peers 127.0.0.1:"$PORT" \
    --training.image_folder "$CORPUS/swav_images" \
    --training.per_device_batch_size 2 \
    --training.save_steps 0 \
    --training.output_dir "$RUN/out_vol" --training.seed 1 \
    > "$RUN/swav_vol.log" 2>&1 &
  echo $!
}
log "cpu swav volunteer up"
VOL=$(cpu_volunteer)

sleep "$CHURN"
log "CHURN: SIGKILL swav volunteer (pid $VOL)"
kill -9 "$VOL" 2>/dev/null
sleep "$REJOIN"
log "CHURN: swav volunteer rejoins"
VOL=$(cpu_volunteer)

ELAPSED=$((CHURN + REJOIN))
sleep $((TOTAL - ELAPSED))
log "shutting down"
kill "$CARD" "$VOL" "$AUX" 2>/dev/null
sleep 25
kill -9 "$CARD" "$VOL" "$AUX" 2>/dev/null
kill "$COORD" 2>/dev/null
log "done"
