#!/bin/bash
# The port's sustained runs on the card, one stage after another, each
# summarised by dedloc_tpu_torch/tools/sustained.py into $OUT:
#
#   STAGES="albert_solo swav" bash dedloc_tpu_torch/tools/sustained_runs.sh
#   STAGES="albert_fleet" bash dedloc_tpu_torch/tools/sustained_runs.sh
#
#   albert_solo   word-level MLM+SOP shards (S=128, 30,000 ids, from the
#                 standard library's and the installed packages' docs,
#                 word_corpus.py) and their unigram entropy; then one
#                 ALBERT-large trainer on the card for SOLO_S seconds
#                 (hetero_converge.sh MODE=solo: the round-5 recipe, target
#                 batch 512, LAMB 6e-4, warmup 250, flash + fused_ln, PDB x
#                 ACCUM samples a boundary); the stage passes when the
#                 mean MLM loss of the last 100 steps is below the entropy
#   albert_fleet  the same shards; hetero_converge.sh MODE=probe for
#                 FLEET_S seconds (the card trainer, two CPU volunteers at
#                 batch 1, an aux, a coordinator), every peer checkpointing
#                 each step it takes and the peers' states hashed at every
#                 step two of them hold
#   swav          PIL first (the texture images and the multicrop pipeline
#                 need it); the texture set (swav_probe.py generate), the
#                 round-4 recipe (ResNet-50 SwAV, 16 images a boundary,
#                 target 16, LARS 0.15, warmup 200, queue 3,840 from global
#                 step 400) for SWAV_BOUNDARIES boundaries (a solo peer
#                 steps every second boundary: 700 global steps), then the
#                 linear probe of the trained and of a random trunk
#
# Big files (shards, images, checkpoints) go under $WORK; summaries and
# logs under $OUT ($WORK/out unless set). A stage that fails leaves its log in $OUT and the next
# stage still runs; the script exits non-zero if any stage failed.
set -u
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
TOOLS="$REPO/dedloc_tpu_torch/tools"
WORK=${WORK:-$REPO/dedloc_tpu_torch/build/sustained}
OUT=${OUT:-$WORK/out}
STAGES=${STAGES:-albert_solo swav}
SOLO_S=${SOLO_S:-1800}
FLEET_S=${FLEET_S:-1200}
MAX_DOCS=${MAX_DOCS:-20000}
PDB=${PDB:-128}
ACCUM=${ACCUM:-2}
WINDOW=${WINDOW:-30}
SWAV_BOUNDARIES=${SWAV_BOUNDARIES:-1400}
# sizes (a CPU rehearsal: DEDLOC_FORCE_CPU=1 MODEL=tiny SEQ=32 VOCAB=512
# SWAV_SIZE=tiny with short durations)
MODEL=${MODEL:-large}
SEQ=${SEQ:-128}
VOCAB=${VOCAB:-30000}
SWAV_SIZE=${SWAV_SIZE:-full}
SWAV_IMAGE=${SWAV_IMAGE:-224}
mkdir -p "$OUT" "$WORK"
FAILED=""

log() { echo "[sustained] $(date +%T) $*" | tee -a "$OUT/sustained.log"; }

card() {
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>&1 | head -1
}

corpus() {
  if [ -f "$WORK/corpus/corpus.json" ]; then return 0; fi
  local roots
  roots=$(python -c "from dedloc_tpu_torch.data.corpus import default_roots; print(' '.join(default_roots()))")
  log "word corpus: S=$SEQ, $VOCAB ids, at most $MAX_DOCS documents of $roots"
  python -m dedloc_tpu_torch.tools.word_corpus --out "$WORK/corpus" \
    --seq_length "$SEQ" --vocab_size "$VOCAB" --max_docs "$MAX_DOCS" \
    --roots $roots > "$OUT/corpus.json" 2> "$OUT/corpus.err" || return 1
  cat "$OUT/corpus.json" >> "$OUT/sustained.log"
}

albert_solo() {
  corpus || return 1
  log "albert solo: ${SOLO_S} s on $(card)"
  rm -rf "$WORK/solo"
  CORPUS="$WORK/corpus" RUN="$WORK/solo" MODE=solo DURATION="$SOLO_S" \
    PDB="$PDB" ACCUM="$ACCUM" WINDOW="$WINDOW" SAVE_STEPS=250 SAVE_LIMIT=1 \
    MODEL="$MODEL" SEQ="$SEQ" \
    bash "$TOOLS/hetero_converge.sh"
  cp "$WORK/solo/train_log_tpu.jsonl" "$OUT/albert_solo_train_log.jsonl"
  tail -c 200000 "$WORK/solo/trainer_tpu.log" > "$OUT/albert_solo_trainer.log"
  python -m dedloc_tpu_torch.tools.sustained summary "$WORK/solo" \
    --corpus "$WORK/corpus" > "$OUT/albert_solo.json" || return 1
  python - "$OUT/albert_solo.json" <<'EOF'
import json, sys
s = json.load(open(sys.argv[1]))["card"]
print(json.dumps({k: s.get(k) for k in ("steps", "last_step", "step_s_median",
      "samples_per_s_median", "first_mlm_loss", "last_mlm_loss",
      "unigram_entropy_nats", "below_entropy", "launches_as_expected")}))
ok = s.get("finite") and s.get("launches_as_expected") and \
    (s.get("below_entropy") or {}).get("sustained")
sys.exit(0 if ok else 1)
EOF
}

albert_fleet() {
  corpus || return 1
  log "albert fleet (MODE=probe): ${FLEET_S} s on $(card)"
  rm -rf "$WORK/fleet"
  mkdir -p "$WORK/fleet"
  python -m dedloc_tpu_torch.tools.sustained hashes "$WORK/fleet" \
    --watch $((FLEET_S + 120)) > /dev/null 2> "$OUT/fleet_hashes.err" &
  local watcher=$!
  CORPUS="$WORK/corpus" RUN="$WORK/fleet" MODE=probe DURATION="$FLEET_S" \
    PDB="$PDB" ACCUM="$ACCUM" WINDOW="$WINDOW" SAVE_STEPS=1 SAVE_LIMIT=8 \
    VOL_SAVE_STEPS=1 VOL_SAVE_LIMIT=0 MODEL="$MODEL" SEQ="$SEQ" \
    bash "$TOOLS/hetero_converge.sh"
  kill "$watcher" 2>/dev/null
  wait "$watcher" 2>/dev/null
  for f in train_log_tpu.jsonl train_log_vol1.jsonl train_log_vol2.jsonl \
           state_hashes.jsonl orchestrator.log coordinator_metrics.jsonl; do
    [ -f "$WORK/fleet/$f" ] && cp "$WORK/fleet/$f" "$OUT/fleet_$f"
  done
  for f in trainer_tpu.log trainer_vol1.log trainer_vol2.log aux.log coordinator.log; do
    [ -f "$WORK/fleet/$f" ] && tail -c 200000 "$WORK/fleet/$f" > "$OUT/fleet_$f"
  done
  python -m dedloc_tpu_torch.tools.sustained summary "$WORK/fleet" \
    --corpus "$WORK/corpus" > "$OUT/albert_fleet.json" || return 1
}

swav() {
  if ! python -c "import PIL" 2> "$OUT/swav_pil.err"; then
    log "swav: PIL is not installed on this machine; the run waits"
    echo '{"pil": false}' > "$OUT/swav.json"
    return 1
  fi
  log "swav: PIL $(python -c 'import PIL; print(PIL.__version__)'); texture set"
  rm -rf "$WORK/swav_images" "$WORK/swav_out"
  python -m dedloc_tpu_torch.tools.swav_probe generate \
    --out "$WORK/swav_images" --size "$SWAV_IMAGE" \
    > "$OUT/swav_generate.json" || return 1
  log "swav: round-4 recipe, $SWAV_BOUNDARIES boundaries on $(card)"
  python -m dedloc_tpu_torch.roles.swav \
    --dht.experiment_prefix swav_r4 --dht.listen_host 127.0.0.1 \
    --training.image_folder "$WORK/swav_images" --training.model_size "$SWAV_SIZE" \
    --training.per_device_batch_size 16 \
    --optimizer.target_batch_size 16 \
    --training.learning_rate 0.15 --training.warmup_steps 200 \
    --training.total_steps 2500 --training.max_local_steps "$SWAV_BOUNDARIES" \
    --training.queue_length 3840 --training.queue_start_step 400 \
    --training.save_steps 200 --training.save_total_limit 2 \
    --training.output_dir "$WORK/swav_out" > "$WORK/swav_train.log" 2>&1
  local rc=$?
  tail -c 300000 "$WORK/swav_train.log" > "$OUT/swav_train.log"
  python -m dedloc_tpu_torch.tools.sustained swav "$WORK/swav_train.log" \
    > "$OUT/swav_curve.json"
  [ $rc -eq 0 ] || return 1
  log "swav: linear probe, trained and random trunk"
  python -m dedloc_tpu_torch.tools.swav_probe probe \
    --checkpoint_dir "$WORK/swav_out" --model_size "$SWAV_SIZE" \
    > "$OUT/swav_probe.json" \
    2> "$OUT/swav_probe.err" || return 1
  cat "$OUT/swav_curve.json" "$OUT/swav_probe.json" >> "$OUT/sustained.log"
}

log "card: $(card); stages: $STAGES"
for stage in $STAGES; do
  t0=$(date +%s)
  if "$stage"; then
    log "$stage: ok in $(( $(date +%s) - t0 )) s"
  else
    log "$stage: FAILED after $(( $(date +%s) - t0 )) s"
    FAILED="$FAILED $stage"
  fi
done
[ -z "$FAILED" ] || { log "failed:$FAILED"; exit 1; }
log "all stages ok"
