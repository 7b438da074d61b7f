#!/usr/bin/env bash
# In-flight evidence snapshot: copies the LIVE metrics.jsonl of each stage of the 4096-shape
# run (the three trainers, the matcher and its raw-input variant) from its run root into
# chiprun_out/evidence/gen4096/<stage>/metrics.inflight.jsonl. evidence.collect copies a
# stage's metrics only when the stage ends; run this in a loop beside a long run so that its
# curves survive a run cut mid-stage. It makes no commit: chiprun_out/ is not tracked.
set -u
cd "$(dirname "$0")/../.."
RUN=${TMPDIR:-/tmp}/pfpp_torch_gen_4096
DST=chiprun_out/evidence/gen4096
snap() { # snap <src> <dst>
  local src=$1 dst=$2
  [ -f "$src" ] || return 0
  mkdir -p "$(dirname "$dst")"
  if ! cmp -s "$src" "$dst" 2>/dev/null; then
    cp "$src" "$dst" && echo "snapshot $dst $(date -u +%H:%M:%S)"
  fi
}
snap "$RUN/out/everyday/vqvae/metrics.jsonl"    "$DST/vqvae/metrics.inflight.jsonl"
snap "$RUN/out/everyday/denoiser/metrics.jsonl" "$DST/denoiser/metrics.inflight.jsonl"
snap "$RUN/out/everyday/verifier/metrics.jsonl" "$DST/verifier/metrics.inflight.jsonl"
snap "$RUN/matcher_out/metrics.jsonl"           "$DST/matcher_out/metrics.inflight.jsonl"
snap "$RUN/matcher_out_raw/metrics.jsonl"       "$DST/matcher_out_raw/metrics.inflight.jsonl"
