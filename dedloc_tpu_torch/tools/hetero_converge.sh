#!/bin/bash
# The heterogeneous collaborative run over the port's roles
# (python -m dedloc_tpu_torch.roles.*), the counterpart of
# tools/hetero_converge.sh: a trainer on the card + 2 client-mode CPU
# volunteers (each registered with k=2 circuit relays, upgrading
# peer<->peer paths by NAT punch / connection reversal) + an aux bandwidth
# donor + the coordinator running the AllowlistAuthServer, so every
# matchmaking envelope is gated. The recipe is the solo one (target batch
# 512, LAMB 6e-4, warmup 250, flash + fused_ln).
#
# Data: MLM+SOP shards from dedloc_tpu_torch/tools/word_corpus.py under
# $CORPUS (train/, holdout/). The reference's volunteers stream raw text
# through a trained tokenizer; here every peer reads the word-level shards
# (with its own shuffling seed), so the run needs no tokenizers package.
#
# Modes:
#   MODE=probe    — fixed-DURATION run, no churn (participation vs the
#                   card's cadence; tools/participation_summary.py reads
#                   the logs as they are: the card trainer keeps the
#                   reference's file names trainer_tpu.log and
#                   train_log_tpu.jsonl).
#   MODE=converge — the long run: two SIGKILL/rejoin churn events, runs
#                   until TOTAL seconds elapsed.
#   MODE=solo     — the card trainer alone (no coordinator, aux or
#                   volunteers) for DURATION seconds: the solo run the
#                   fleet's loss is held against, with the same flags.
#
# Usage (from anywhere; the repo is found from this file's path):
#   python -m dedloc_tpu_torch.tools.word_corpus --out $CORPUS --seq_length 128
#   CORPUS=/path/corpus RUN=/path/run WINDOW=30 MODE=probe DURATION=420 \
#     bash dedloc_tpu_torch/tools/hetero_converge.sh
#   CORPUS=/path/corpus RUN=/path/converge WINDOW=30 MODE=converge \
#     TOTAL=23400 CHURN1=5400 REJOIN1=600 CHURN2=14400 REJOIN2=600 \
#     bash dedloc_tpu_torch/tools/hetero_converge.sh
#
# The card trainer takes the card (it raises without one); the volunteers
# run on the CPU because DEDLOC_FORCE_CPU=1 asks for it. The coordinator
# and the aux hold no tensor on a device and start with CUDA hidden.
# tools/hetero_converge.sh also exports JAX_COMPILATION_CACHE_DIR and sets
# JAX_PLATFORMS=cpu; neither has a counterpart: PyTorch runs eagerly (no
# program to compile and cache; the CUDA kernels are built once per
# checkout under dedloc_tpu_torch/build), and the device is chosen by
# DEDLOC_FORCE_CPU.
set -u
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
CORPUS=${CORPUS:?set CORPUS to a word_corpus.py output directory}
RUN=${RUN:-$CORPUS/r5_run}
PREFIX=${PREFIX:-hetero5}
PORT=${PORT:-41000}        # coordinator (DHT bootstrap + auth server)
# the AVERAGER'S RPC server is the circuit relay (dht/protocol.py
# RelayService attaches to listening averagers) — pin those ports and
# point the volunteers' --dht.relay at them
CARD_AVG_PORT=${CARD_AVG_PORT:-41011}  # card trainer averager = relay 1
AUX_AVG_PORT=${AUX_AVG_PORT:-41013}    # aux donor averager = relay 2
WINDOW=${WINDOW:-30}
TARGET=${TARGET:-512}
LEAD=${LEAD:-0}
MODE=${MODE:-probe}
DURATION=${DURATION:-420}
TOTAL=${TOTAL:-23400}
CHURN1=${CHURN1:-5400}
REJOIN1=${REJOIN1:-600}
CHURN2=${CHURN2:-14400}
REJOIN2=${REJOIN2:-600}
SAVE_STEPS=${SAVE_STEPS:-250}
SAVE_LIMIT=${SAVE_LIMIT:-0}   # 0 keeps every checkpoint
VOL_SAVE_STEPS=${VOL_SAVE_STEPS:-0}
VOL_SAVE_LIMIT=${VOL_SAVE_LIMIT:-0}
TOTAL_STEPS=${TOTAL_STEPS:-4000}
MODEL=${MODEL:-large}
SEQ=${SEQ:-128}
# the card trainer's micro-batch and accumulation (the reference's TPU
# peer: 12 x 4); samples per boundary = PDB x ACCUM
PDB=${PDB:-12}
ACCUM=${ACCUM:-4}
VOL_THREADS=${VOL_THREADS:-2}  # torch threads per CPU volunteer
RELAYS="127.0.0.1:$CARD_AVG_PORT,127.0.0.1:$AUX_AVG_PORT"
# gated run: coordinator holds the allowlist, every peer presents creds
ALLOW="tpu:r5-tpu-pw,vol1:r5-vol1-pw,vol2:r5-vol2-pw,aux:r5-aux-pw"
mkdir -p "$RUN"

COMMON="--dht.experiment_prefix $PREFIX --optimizer.target_batch_size $TARGET \
  --optimizer.batch_size_lead $LEAD \
  --averager.averaging_expiration $WINDOW --averager.averaging_timeout 180 \
  --training.learning_rate 0.0006 --training.warmup_steps 250 \
  --training.total_steps $TOTAL_STEPS --training.model_size $MODEL \
  --training.seq_length $SEQ"

log() { echo "[orc] $(date +%T) $*" | tee -a "$RUN/orchestrator.log"; }

card_trainer() {
  # flags of the reference's TPU peer; with MODE=solo no coordinator
  # exists, the trainer bootstraps its own DHT and runs without auth
  local extra=""
  if [ "$MODE" != solo ]; then
    extra="--dht.initial_peers 127.0.0.1:$PORT \
      --auth.username tpu --auth.credential r5-tpu-pw"
  fi
  python -m dedloc_tpu_torch.roles.trainer $COMMON $extra \
    --averager.listen_port "$CARD_AVG_PORT" \
    --training.dataset_path "$CORPUS/train" \
    --training.per_device_batch_size "$PDB" \
    --training.gradient_accumulation_steps "$ACCUM" \
    --training.remat_policy fused_ln --training.attention_impl flash \
    --training.train_log_path "$RUN/train_log_tpu.jsonl" \
    --training.output_dir "$RUN/outputs" --training.save_steps "$SAVE_STEPS" \
    --training.save_total_limit "$SAVE_LIMIT" \
    --training.seed 0 \
    > "$RUN/trainer_tpu.log" 2>&1 &
  echo $!
}

if [ "$MODE" = solo ]; then
  log "card trainer up, solo (flash + fused_ln, ${PDB}x${ACCUM}, LAMB 6e-4 w250)"
  CARD=$(card_trainer)
  sleep "$DURATION"
  log "solo done; shutting down"
  kill "$CARD" 2>/dev/null
  for _ in $(seq 25); do kill -0 "$CARD" 2>/dev/null || break; sleep 1; done
  kill -9 "$CARD" 2>/dev/null
  log "done"
  exit 0
fi

log "coordinator up (auth-gated: allowlist of 4)"
python -m dedloc_tpu_torch.roles.coordinator \
  --dht.experiment_prefix "$PREFIX" --dht.listen_port "$PORT" \
  --coordinator.auth_allowlist "$ALLOW" \
  --coordinator.refresh_period 20 --coordinator.upload_interval 0 \
  --coordinator.metrics_log_path "$RUN/coordinator_metrics.jsonl" \
  > "$RUN/coordinator.log" 2>&1 &
COORD=$!
sleep 8

log "card trainer up (solo recipe: flash + fused_ln, ${PDB}x${ACCUM}, LAMB 6e-4 w250)"
CARD=$(card_trainer)
sleep 10

log "aux up (public listener + relay 2)"
nice -n 19 python -m dedloc_tpu_torch.roles.aux \
  --dht.experiment_prefix "$PREFIX" --dht.initial_peers 127.0.0.1:"$PORT" \
  --averager.listen_port "$AUX_AVG_PORT" \
  --auth.username aux --auth.credential r5-aux-pw \
  --training.model_size "$MODEL" --training.seq_length "$SEQ" \
  --optimizer.target_batch_size "$TARGET" \
  --averager.averaging_expiration "$WINDOW" --averager.averaging_timeout 180 \
  > "$RUN/aux.log" 2>&1 &
AUX=$!
# let the two relay hosts (card trainer + aux) start listening before the
# client-mode volunteers try to register with them
sleep 35

cpu_volunteer() {
  # a private volunteer: outbound-only (client_mode), reachable through the
  # k=2 circuit relays; volunteer<->volunteer averaging spans upgrade via
  # NAT hole punch, volunteer<->public via connection reversal. Seq 128,
  # batch 1 — same param schema as the card peer so gradients average.
  local i=$1
  DEDLOC_FORCE_CPU=1 OMP_NUM_THREADS="$VOL_THREADS" nice -n 19 \
    python -m dedloc_tpu_torch.roles.trainer $COMMON \
    --dht.initial_peers 127.0.0.1:"$PORT" \
    --dht.client_mode true --dht.relay "$RELAYS" \
    --auth.username "vol$i" --auth.credential "r5-vol$i-pw" \
    --training.dataset_path "$CORPUS/train" \
    --training.per_device_batch_size 1 \
    --training.gradient_accumulation_steps 1 \
    --training.remat_policy nothing --training.attention_impl dense \
    --averager.bandwidth 100 \
    --training.train_log_path "$RUN/train_log_vol$i.jsonl" \
    --training.output_dir "$RUN/out_vol$i" \
    --training.save_steps "$VOL_SAVE_STEPS" \
    --training.save_total_limit "$VOL_SAVE_LIMIT" \
    --training.seed "$i" \
    > "$RUN/trainer_vol$i.log" 2>&1 &
  echo $!
}
log "client-mode volunteers up (relays: $RELAYS)"
V1=$(cpu_volunteer 1)
V2=$(cpu_volunteer 2)

if [ "$MODE" = probe ]; then
  sleep "$DURATION"
  log "probe window=$WINDOW done"
else
  sleep "$CHURN1"
  log "CHURN 1: SIGKILL vol2 (pid $V2)"
  kill -9 "$V2" 2>/dev/null
  sleep "$REJOIN1"
  log "CHURN 1: vol2 rejoins (state pull over the hardened path)"
  V2=$(cpu_volunteer 2)
  ELAPSED=$((CHURN1 + REJOIN1))
  sleep $((CHURN2 - ELAPSED))
  log "CHURN 2: SIGKILL vol1 (pid $V1)"
  kill -9 "$V1" 2>/dev/null
  sleep "$REJOIN2"
  log "CHURN 2: vol1 rejoins"
  V1=$(cpu_volunteer 1)
  ELAPSED=$((CHURN2 + REJOIN2))
  sleep $((TOTAL - ELAPSED))
fi

log "shutting down"
kill "$CARD" "$V1" "$V2" "$AUX" 2>/dev/null
sleep 25
kill -9 "$CARD" "$V1" "$V2" "$AUX" 2>/dev/null
kill "$COORD" 2>/dev/null
log "done"
