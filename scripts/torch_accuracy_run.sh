#!/usr/bin/env bash
# The accuracy check at real scale of the PyTorch port on one card:
#
#   bash scripts/torch_accuracy_run.sh [N [PROCS [BUDGET_S]]] [-- FLAGS...]
#
# 1. prints the card's name and power limit and the free disk of the
#    checkout's build/ and of TMPDIR, and keeps the dataset in the first of
#    them with room for N samples (about 22 MB a sample with both presaves);
# 2. generates N synthetic samples at 512x432 (create_syn_data default,
#    procedural objects) in PROCS processes over --start ranges;
# 3. scores the untrained init of the worker's seed (RunConfig.seed 42:
#    the JAX worker's init from jax.random.key(42)) on the full test split
#    with the exact metric (train_val --cmd test_init; init_metrics.json),
#    then runs tools/pipeline_drive.py on the samples (DIS-SF, its
#    full-split retest, the SF presave, DIS-MF, its retest and presave,
#    DIS-FTSF and its retest) with FLAGS (default: --flow_source pred
#    --sf_epochs 19 --mf_epochs 7) and a --minutes budget of what is left
#    of BUDGET_S seconds after a reserve for step 4;
# 4. retests the self-supervised DIS-SF checkpoint once more with the exact
#    host metric (--eval_metrics exact);
# 5. copies pipeline_summary.json, every stage's metrics.json and train.log,
#    the exact retest's metrics and the logs to FIGURES_DIR (default
#    build/accuracy_figures; on a machine that keeps only one output
#    directory, point it there).
#
# Defaults: N 1536 (the worker's synthetic splits: valid [0:512], test
# [512:1024], train [1024:1536]), PROCS 8, BUDGET_S 3300.
#
# DIS-SF alone, with the whole budget and no MF or FTSF stage:
#
#   bash scripts/torch_accuracy_run.sh 1536 8 2400 -- --flow_source pred \
#       --sf_epochs 19 --mf_epochs 0 --sf_frac 1 --reserve_s 0
set -uo pipefail
cd "$(dirname "$0")/.."
ROOT=$(pwd)
N=1536; PROCS=8; BUDGET_S=3300
[[ $# -gt 0 && $1 != -- ]] && { N=$1; shift; }
[[ $# -gt 0 && $1 != -- ]] && { PROCS=$1; shift; }
[[ $# -gt 0 && $1 != -- ]] && { BUDGET_S=$1; shift; }
[[ $# -gt 0 && $1 == -- ]] && shift
FLAGS=("$@")
[[ ${#FLAGS[@]} -eq 0 ]] && FLAGS=(--flow_source pred --sf_epochs 19 --mf_epochs 7)
EXACT_RESERVE_S=300
T0=$(date +%s)
OUT=${FIGURES_DIR:-$ROOT/build/accuracy_figures}
mkdir -p "$OUT"
log() { echo "[accuracy] $(( $(date +%s) - T0 )) s: $*" | tee -a "$OUT/run.log"; }

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))' | tee -a "$OUT/card.txt"
mkdir -p "$ROOT/build"
TMP_ROOT=${TMPDIR:-/tmp}
df -h "$ROOT/build" "$TMP_ROOT" | tee "$OUT/df.txt"
NEED_KB=$(( N * 22 * 1024 + 2 * 1024 * 1024 ))
BASE=
for cand in "$ROOT/build" "$TMP_ROOT"; do
  free_kb=$(df -Pk "$cand" | awk 'NR == 2 {print $4}')
  if (( free_kb >= NEED_KB )); then BASE=$cand/dis_accuracy; break; fi
done
if [[ -z $BASE ]]; then
  log "no disk with $(( NEED_KB / 1024 / 1024 )) GiB free for $N samples"
  exit 1
fi
rm -rf "$BASE"
mkdir -p "$BASE"
DATA=$BASE/data
RUN_OUT=$BASE/output
log "dataset in $DATA ($(( NEED_KB / 1024 / 1024 )) GiB needed)"

# -- 2. the dataset, PROCS processes over --start ranges
STEP=$(( (N + PROCS - 1) / PROCS ))
pids=()
for (( i = 0; i < PROCS; i++ )); do
  lo=$(( i * STEP )); hi=$(( lo + STEP < N ? lo + STEP : N ))
  (( lo >= hi )) && continue
  python -m depthinspace_tpu_torch.tools.create_syn_data default \
      --objects procedural --data_dir "$DATA" --start $lo --n_samples $hi \
      > "$OUT/gen_$i.log" 2>&1 &
  pids+=($!)
done
gen_ok=1
for p in "${pids[@]}"; do wait "$p" || gen_ok=0; done
T_GEN=$(( $(date +%s) - T0 ))
n_made=$(ls -d "$DATA"/0*/ 2>/dev/null | wc -l)
log "generated $n_made of $N samples in $PROCS processes ($T_GEN s since the start)"
du -sh "$DATA" | tee -a "$OUT/run.log"
df -h "$BASE" | tee -a "$OUT/df.txt"
if (( gen_ok == 0 || n_made != N )); then
  log "generation failed"; tail -n 5 "$OUT"/gen_*.log; exit 1
fi

# -- 3. the init of the worker's seed, then the staged pipeline
printf '{"DATA_DIR": "%s", "OUTPUT_DIR": "%s"}\n' "$DATA" "$RUN_OUT" > "$BASE/config.json"
export DIS_CONFIG=$BASE/config.json
log "train_val --cmd test_init"
timeout -k 30 600 python -m depthinspace_tpu_torch.train_val \
    --architecture single_frame --cmd test_init --flow_source pred \
    --eval_metrics exact --test_batch_size 16 > "$OUT/test_init.log" 2>&1
log "test_init exited with $?"
python -c 'import json, sys; print(json.dumps(json.load(open(sys.argv[1]))["-1"]["test"]))' \
    "$RUN_OUT/single_frame/metrics.json" | tee "$OUT/init_metrics.json"
LEFT=$(( BUDGET_S - ($(date +%s) - T0) - EXACT_RESERVE_S ))
MINUTES=$(python -c "print(round($LEFT / 60, 2))")
log "pipeline_drive --minutes $MINUTES ${FLAGS[*]}"
timeout -k 30 $(( LEFT + 120 )) python -m depthinspace_tpu_torch.tools.pipeline_drive \
    --minutes "$MINUTES" "${FLAGS[@]}" > "$OUT/pipeline.log" 2>&1
log "pipeline_drive exited with $?"
grep -a "=== pipeline stage\|pipeline finished\|Error\|error" "$OUT/pipeline.log" | tail -n 40

# -- 4. the self-supervised SF checkpoint retested with the exact metric
SF_DIR=$RUN_OUT/single_frame_selfsup
[[ -d $SF_DIR ]] || SF_DIR=$RUN_OUT/single_frame
timeout -k 30 $(( EXACT_RESERVE_S - 60 )) python - "$SF_DIR" "$DATA" "$BASE/exact" \
    > "$OUT/exact_retest.log" 2>&1 <<'EOF'
import json, shutil, sys, time
from pathlib import Path
from depthinspace_tpu_torch.config import RunConfig
from depthinspace_tpu_torch.train.single_frame import SingleFrameWorker
sf_dir, data, out = (Path(a) for a in sys.argv[1:])
epoch = max(int(p.stem.split("_")[1]) for p in sf_dir.glob("net_*.params"))
(out / "single_frame").mkdir(parents=True, exist_ok=True)
shutil.copy(sf_dir / f"net_{epoch:04d}.params", out / "single_frame")
cfg = RunConfig(data_dir=data, output_dir=out, architecture="single_frame",
                flow_source="pred", test_batch_size=16, epochs=epoch + 1,
                eval_metrics="exact", write_debug_images=False)
t0 = time.time()
SingleFrameWorker(cfg).retest(epoch=epoch)
m = json.loads((out / "single_frame" / "metrics.json").read_text())
print(f"exact retest of {sf_dir.name} epoch {epoch}: {time.time() - t0:.1f} s")
print(json.dumps(m[str(epoch)]["test"]))
EOF
log "exact retest exited with $?"
tail -n 2 "$OUT/exact_retest.log"

# -- 5. the figures
cp "$RUN_OUT/pipeline_summary.json" "$OUT/" 2>/dev/null
for d in single_frame_selfsup single_frame multi_frame; do
  for f in metrics.json train.log; do
    [[ -f $RUN_OUT/$d/$f ]] && cp "$RUN_OUT/$d/$f" "$OUT/${d}_$f"
  done
done
cp "$BASE/exact/single_frame/metrics.json" "$OUT/exact_retest_metrics.json" 2>/dev/null
log "done"
