#!/bin/bash
# Heterogeneous multi-peer collaborative run on ONE host over the port's
# roles (python -m dedloc_tpu_torch.roles.*), the counterpart of
# tools/hetero_run.sh: a trainer peer on the card + N slow CPU trainer
# peers + an aux bandwidth donor + the coordinator, with a SIGKILL churn
# event and a rejoin — the single-host analogue of the reference's AWS
# fleet (albert/AWS_runner.ipynb: heterogeneous workers + aux +
# coordinator, spot churn + respawn).
#
# Usage:
#   python -m dedloc_tpu_torch.tools.word_corpus --out $CORPUS/tokenized \
#     --seq_length 512
#   CORPUS=/path/corpus RUN=/path/run bash dedloc_tpu_torch/tools/hetero_run.sh
#
# Expects under $CORPUS: tokenized/train (seq-512 MLM+SOP shards from
# word_corpus.py) for the card peer, and tokenized128/train (seq-128) for
# the CPU peers. The reference's CPU peers stream raw text through a
# trained tokenizer; here they read word-level shards, so the run needs no
# tokenizers package. The card trainer takes the card; the CPU peers run
# with DEDLOC_FORCE_CPU=1; the coordinator and aux start with CUDA hidden.
# tools/hetero_run.sh's JAX_PLATFORMS=cpu has no counterpart: the device is
# chosen by DEDLOC_FORCE_CPU.
set -u
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
CORPUS=${CORPUS:?set CORPUS to a directory of word_corpus.py outputs}
RUN=${RUN:-$CORPUS/hetero_run}
PREFIX=${PREFIX:-hetero}
PORT=${PORT:-41000}
N_CPU=${N_CPU:-2}
TARGET=${TARGET:-4096}          # reference default global batch
CHURN_AT=${CHURN_AT:-2700}      # SIGKILL a CPU peer after this many secs
REJOIN_AFTER=${REJOIN_AFTER:-900}
TAIL=${TAIL:-3300}              # run this long after the rejoin
VOL_THREADS=${VOL_THREADS:-2}   # torch threads per CPU peer
mkdir -p "$RUN"
COMMON="--dht.experiment_prefix $PREFIX --optimizer.target_batch_size $TARGET \
  --averager.averaging_expiration 15 --averager.averaging_timeout 120 \
  --training.learning_rate 0.0015 --training.warmup_steps 15 \
  --training.total_steps 150"

log() { echo "[orc] $(date +%T) $*" | tee -a "$RUN/orchestrator.log"; }

log "coordinator up"
python -m dedloc_tpu_torch.roles.coordinator \
  --dht.experiment_prefix "$PREFIX" --dht.listen_port "$PORT" \
  --coordinator.refresh_period 20 --coordinator.upload_interval 0 \
  --coordinator.metrics_log_path "$RUN/coordinator_metrics.jsonl" \
  > "$RUN/coordinator.log" 2>&1 &
COORD=$!
sleep 8

log "card trainer up (flagship recipe: flash + fused_ln)"
python -m dedloc_tpu_torch.roles.trainer $COMMON \
  --dht.initial_peers 127.0.0.1:"$PORT" \
  --training.dataset_path "$CORPUS/tokenized/train" \
  --training.per_device_batch_size 12 \
  --training.gradient_accumulation_steps 4 \
  --training.remat_policy fused_ln --training.attention_impl flash \
  --training.train_log_path "$RUN/train_log_tpu.jsonl" \
  --training.output_dir "$RUN/outputs" --training.save_steps 20 \
  --training.seed 0 \
  > "$RUN/trainer_tpu.log" 2>&1 &
CARD=$!
sleep 30

cpu_trainer() {
  # a slow volunteer: the CPU, seq 128, batch 1 — same MODEL (param
  # schema), so its gradients average with the card peer's; nice'd so the
  # card peer's host-side work keeps the cores when contended
  local i=$1
  DEDLOC_FORCE_CPU=1 OMP_NUM_THREADS="$VOL_THREADS" nice -n 19 \
    python -m dedloc_tpu_torch.roles.trainer $COMMON \
    --dht.initial_peers 127.0.0.1:"$PORT" \
    --training.dataset_path "$CORPUS/tokenized128/train" \
    --training.seq_length 128 \
    --training.per_device_batch_size 1 \
    --training.gradient_accumulation_steps 1 \
    --training.remat_policy nothing --training.attention_impl dense \
    --averager.bandwidth 100 \
    --training.train_log_path "$RUN/train_log_cpu$i.jsonl" \
    --training.output_dir "$RUN/out_cpu$i" --training.save_steps 0 \
    --training.seed "$i" \
    > "$RUN/trainer_cpu$i.log" 2>&1 &
  echo $!
}
log "cpu trainers up"
CPUS=()
for i in $(seq 1 "$N_CPU"); do CPUS+=("$(cpu_trainer "$i")"); done

log "aux up"
nice -n 19 python -m dedloc_tpu_torch.roles.aux \
  --dht.experiment_prefix "$PREFIX" --dht.initial_peers 127.0.0.1:"$PORT" \
  --training.model_size large --training.seq_length 128 \
  --optimizer.target_batch_size "$TARGET" \
  --averager.averaging_expiration 15 --averager.averaging_timeout 120 \
  > "$RUN/aux.log" 2>&1 &
AUX=$!

sleep "$CHURN_AT"
VICTIM=${CPUS[-1]}
log "CHURN: SIGKILL cpu trainer $N_CPU (pid $VICTIM)"
kill -9 "$VICTIM" 2>/dev/null
sleep "$REJOIN_AFTER"
log "CHURN: restarting cpu trainer $N_CPU (rejoins via state pull)"
CPUS[-1]=$(cpu_trainer "$N_CPU")

sleep "$TAIL"
log "shutting down"
kill "$CARD" "${CPUS[@]}" "$AUX" 2>/dev/null
sleep 20
kill -9 "$CARD" "${CPUS[@]}" "$AUX" 2>/dev/null
kill "$COORD" 2>/dev/null
log "done"
