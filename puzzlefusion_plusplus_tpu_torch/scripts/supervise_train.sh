#!/usr/bin/env bash
# Relaunch supervisor for long trainings on a CUDA host.
#
# A trainer that crashes or is killed (a card fault, the host's OOM killer, the stall
# watchdog) is started again; the port's trainers checkpoint at every validation and resume
# from the latest checkpoint (training/state.py::maybe_restore continues the step counter):
#
#   puzzlefusion_plusplus_tpu_torch/scripts/supervise_train.sh /tmp/run.pid /tmp/run.log \
#       ENV1=v1 ... -- python -m puzzlefusion_plusplus_tpu_torch.training.vqvae ...
#
# Writes the CURRENT child pid to $1 after each relaunch (kill "$(cat $1)" and remove the pid
# file to stop the loop; never pkill -f, which matches your own shell). Appends the child's
# stdout/stderr to $2. Stops when the child exits 0 (run complete) or the pid file is removed.
set -u
PIDFILE=$1; shift
LOG=$1; shift
ENVS=()
while [[ $# -gt 0 && "$1" != "--" ]]; do ENVS+=("$1"); shift; done
[[ "${1:-}" == "--" ]] && shift
echo "supervisor $$: ${ENVS[*]} $*" >> "$LOG"
# Crash-loop breaker: MAX_FAST consecutive exits faster than FAST_S seconds (a run that fails
# at start-up, every time) => stop and leave a marker with the log's tail instead of
# relaunching forever.
FAST_S=${SUPERVISE_FAST_S:-600}
MAX_FAST=${SUPERVISE_MAX_FAST:-4}
FASTCOUNT=0
while true; do
  T0=$(date +%s)
  env "${ENVS[@]}" "$@" >> "$LOG" 2>&1 &
  CHILD=$!
  echo "$CHILD" > "$PIDFILE"
  wait "$CHILD"
  RC=$?
  ELAPSED=$(( $(date +%s) - T0 ))
  echo "supervisor: child $CHILD exited rc=$RC after ${ELAPSED}s $(date -u +%H:%M:%S)" >> "$LOG"
  if [[ $RC -eq 0 ]]; then rm -f "$PIDFILE"; echo "supervisor: run complete" >> "$LOG"; break; fi
  if [[ ! -f "$PIDFILE" ]]; then echo "supervisor: pid file removed, stopping" >> "$LOG"; break; fi
  if [[ $ELAPSED -lt $FAST_S ]]; then FASTCOUNT=$((FASTCOUNT + 1)); else FASTCOUNT=0; fi
  if [[ $FASTCOUNT -ge $MAX_FAST ]]; then
    MARKER="${PIDFILE%.pid}.crashloop"
    { echo "supervisor: CRASH LOOP — $FASTCOUNT consecutive exits under ${FAST_S}s; stopping $(date -u +%H:%M:%S)"
      echo "--- last 60 log lines ---"
      tail -n 60 "$LOG"
    } > "$MARKER"
    echo "supervisor: crash loop detected, stopping (marker: $MARKER)" >> "$LOG"
    rm -f "$PIDFILE"
    break
  fi
  sleep 5
done
