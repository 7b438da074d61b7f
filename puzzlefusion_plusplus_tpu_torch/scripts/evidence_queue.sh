#!/usr/bin/env bash
# The evidence queue on a CUDA host (the port's counterpart of scripts/tpu_evidence_queue.sh),
# meant to run under supervise_train.sh: each stage is marker-gated
# (<tmp>/pfpp_torch_*.done), so a relaunch resumes where the last run stopped, and the
# drivers resume their trainings from their checkpoints. Stages in the JAX queue's order
# and with its settings: the minutes-scale bench stages (C, D) and the resurrection eval (A0)
# first, the hours-scale trainings (A, B) after them, then the later probes. A stage marked
# non-fatal prints its failure and the queue goes on; the others, and every bench, stop the
# queue (exit 1).
set -u -o pipefail
cd "$(dirname "$0")/../.."
T=${TMPDIR:-/tmp}
EV=chiprun_out/evidence/bench; mkdir -p "$EV"
PY=puzzlefusion_plusplus_tpu_torch

bench_ok() { # bench_ok <jsonl> [bench args...]: the bench entry's line, kept; a bench that
  # fails exits non-zero, and so does this
  local out_file=$1; shift
  local out
  out=$(python -m $PY.bench "$@") || return 1
  printf '%s\n' "$out"               # the JSON line, visible in the queue's log
  printf '%s\n' "$out" >> "$out_file"
}

# stage C: three fresh-process benches after one uncounted warm-up (the first builds the
# kernels), then the full-range (3-20 part) serving metric
if [ ! -f "$T/pfpp_torch_bench3.done" ]; then
  echo "=== stage C: bench determinism $(date -u +%H:%M:%S)"
  : > "$EV/warmup.jsonl"   # one row: relaunches must not accumulate duplicates
  bench_ok "$EV/warmup.jsonl" || exit 1
  for i in 1 2 3; do bench_ok "$EV/determinism.jsonl" || exit 1; done
  bench_ok "$EV/full_range.jsonl" --full-range || exit 1
  touch "$T/pfpp_torch_bench3.done"
fi

# stage D: kernel S's gather modes, the default ('onehot') and 'dynamic', on the engine's
# hot path. In the port both are the exact gather (ops/sa_fused.py::sa_gather_mode), so this
# stage is a same-function check: it shows that the 'dynamic' setting runs, and its two
# lines differ by the timing noise between two fresh processes, no more. A failed bench
# stops the queue.
if [ ! -f "$T/pfpp_torch_gathercmp.done" ]; then
  echo "=== stage D: gather-impl comparison $(date -u +%H:%M:%S)"
  bench_ok "$EV/gather_onehot.jsonl" || exit 1
  PFPP_SA_GATHER=dynamic bench_ok "$EV/gather_dynamic.jsonl" || exit 1
  touch "$T/pfpp_torch_gathercmp.done"
fi

# stage A0: a 512-shape run whose VQ-VAE and denoiser checkpoints exist: train only the
# verifier (1000 steps) and run the held-out engine eval. Non-fatal.
if [ ! -f "$T/pfpp_torch_gen512_eval.done" ] && [ -d "$T/pfpp_torch_gen_512/out/everyday/denoiser/ckpt" ]; then
  echo "=== stage A0: gen512 resurrection eval $(date -u +%H:%M:%S)"
  touch "$T/pfpp_torch_gen_512/.stage1_plateau" "$T/pfpp_torch_gen_512/.stage2_plateau"
  N_TRAIN=512 N_VAL=32 STEPS_VF=1000 PLATEAU_X=1 \
    python -m $PY.scripts.synthetic_train_eval \
    && touch "$T/pfpp_torch_gen512_eval.done" \
    || echo "stage A0 failed (non-fatal) $(date -u +%H:%M:%S)"
fi

# stage A: the three stages at scale (AE 4000 + DN 12000 + VF 1000 on 4096 shapes,
# plateau-extended up to PLATEAU_X) and the held-out engine metrics. The 4096-shape
# settings are pinned here, so that a relaunch never falls back to the driver's defaults.
if [ ! -f "$T/pfpp_torch_gen4096_train.done" ]; then
  echo "=== stage A: synthetic_train_eval $(date -u +%H:%M:%S)"
  N_TRAIN=4096 N_VAL=32 STEPS_AE=4000 STEPS_DN=12000 STEPS_VF=1000 PLATEAU_X=1.5 \
    python -m $PY.scripts.synthetic_train_eval || exit 1
  touch "$T/pfpp_torch_gen4096_train.done"
fi

# stage A1: the denoiser's sampling metrics on its own training shapes: optimization gap
# (train also low) against generalization gap (train high, held-out low). Non-fatal.
if [ ! -f "$T/pfpp_torch_gen4096_trainsplit.done" ] && [ -f "$T/pfpp_torch_gen4096_train.done" ]; then
  echo "=== stage A1: train-split sampling eval $(date -u +%H:%M:%S)"
  N_TRAIN=4096 SUBSET=32 BATCH=16 SPLIT=train timeout 2400 \
    python -m $PY.scripts.eval_train_split \
    && touch "$T/pfpp_torch_gen4096_trainsplit.done" \
    || echo "stage A1 failed (non-fatal) $(date -u +%H:%M:%S)"
fi

# stage B: the matcher at scale: the held-out mat_f1 curve against its oracle ceiling and
# the matching_data round trip through the engine, at 1000 points (the ceiling falls with
# density: matching/oracle.py) with per-piece PCA inputs; then the bottleneck decomposition
# of its checkpoint (non-fatal)
if [ ! -f "$T/pfpp_torch_matcher.done" ]; then
  echo "=== stage B: matcher_train_eval $(date -u +%H:%M:%S)"
  N_TRAIN=4096 N_VAL=32 EPOCHS=10 BATCH=4 NUM_POINTS=1000 VAL_EVERY=1 \
    MAT_EPOCH=1 RIG_EPOCH=8 CANONICALIZE=1 python -m $PY.scripts.matcher_train_eval || exit 1
  CKPT=$T/pfpp_torch_gen_4096/matcher_out/ckpt DATA=$T/pfpp_torch_gen_4096 NUM_POINTS=1000 \
    MAX_PARTS=20 PC_FEAT=128 AFF_FEAT=512 SA_NPOINTS=1024,256,64,16 OUT_TAG=gen4096 \
    CANONICALIZE=1 python -m $PY.scripts.matcher_diagnosis \
    || echo "stage B diagnosis failed (non-fatal) $(date -u +%H:%M:%S)"
  touch "$T/pfpp_torch_matcher.done"
fi

# stage B2: the reference-parity raw-input matcher at the same budget, the controlled
# comparison for the canonicalization
if [ ! -f "$T/pfpp_torch_matcher_raw.done" ]; then
  echo "=== stage B2: matcher raw-input variant $(date -u +%H:%M:%S)"
  N_TRAIN=4096 N_VAL=32 EPOCHS=10 BATCH=4 NUM_POINTS=1000 VAL_EVERY=1 \
    MAT_EPOCH=1 RIG_EPOCH=8 CANONICALIZE=0 \
    MATCHER_OUT=$T/pfpp_torch_gen_4096/matcher_out_raw \
    python -m $PY.scripts.matcher_train_eval || exit 1
  touch "$T/pfpp_torch_matcher_raw.done"
fi

# stage F: kernel S's int8 gather against the exact gather, fresh processes. A failed bench
# stops the queue.
if [ ! -f "$T/pfpp_torch_gather_int8.done" ]; then
  echo "=== stage F: int8 gather A/B $(date -u +%H:%M:%S)"
  bench_ok "$EV/gather_int8_baseline.jsonl" || exit 1
  PFPP_SA_GATHER=int8 bench_ok "$EV/gather_int8.jsonl" || exit 1
  touch "$T/pfpp_torch_gather_int8.done"
fi

# stage F2: the engine's sensitivity to the matcher's data against the GT data: merges per
# shape under both. Non-fatal.
if [ ! -f "$T/pfpp_torch_match_sens.done" ]; then
  echo "=== stage F2: matching sensitivity probe $(date -u +%H:%M:%S)"
  N_TRAIN=4096 BATCH=8 timeout 2400 python -m $PY.scripts.matching_sensitivity_probe \
    && touch "$T/pfpp_torch_match_sens.done" \
    || echo "stage F2 failed (non-fatal) $(date -u +%H:%M:%S)"
fi

# stage E: the stage-A denoiser past its budget cap: clearing the plateau marker lets
# synthetic_train_eval's stage-2 loop continue from the latest checkpoint, up to
# PLATEAU_X=4.5 times the budget; stage 3 and the held-out engine run again at the end.
if [ ! -f "$T/pfpp_torch_gen4096_ext.done" ]; then
  echo "=== stage E: extended denoiser training $(date -u +%H:%M:%S)"
  rm -f "$T/pfpp_torch_gen_4096/.stage2_plateau"
  N_TRAIN=4096 N_VAL=32 STEPS_AE=4000 STEPS_DN=12000 STEPS_VF=1000 PLATEAU_X=4.5 \
    python -m $PY.scripts.synthetic_train_eval || exit 1
  touch "$T/pfpp_torch_gen4096_ext.done"
fi

# stage E1: the train-split eval again, on the extended checkpoint. Non-fatal.
if [ ! -f "$T/pfpp_torch_gen4096_trainsplit_ext.done" ]; then
  echo "=== stage E1: train-split eval (extended ckpt) $(date -u +%H:%M:%S)"
  N_TRAIN=4096 SUBSET=32 BATCH=16 SPLIT=train timeout 2400 \
    python -m $PY.scripts.eval_train_split \
    && touch "$T/pfpp_torch_gen4096_trainsplit_ext.done" \
    || echo "stage E1 failed (non-fatal) $(date -u +%H:%M:%S)"
fi

# stage E2: verifier data from the extended denoiser (the reference's provenance), a fresh
# verifier trained on it, and the engine under both verifiers. Non-fatal.
if [ ! -f "$T/pfpp_torch_gen4096_vfdn.done" ]; then
  echo "=== stage E2: verifier provenance A/B $(date -u +%H:%M:%S)"
  N_TRAIN=4096 MAX_SAMPLES=1500 STEPS_VF=1000 timeout 7200 \
    python -m $PY.scripts.verifier_regen_eval \
    && touch "$T/pfpp_torch_gen4096_vfdn.done" \
    || echo "stage E2 failed (non-fatal) $(date -u +%H:%M:%S)"
fi

echo "=== queue complete $(date -u +%H:%M:%S)"
exit 0
