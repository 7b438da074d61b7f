#!/usr/bin/env bash
# Stall watchdog for a supervised training (supervise_train.sh) on a CUDA host.
#
#   puzzlefusion_plusplus_tpu_torch/scripts/stall_watchdog.sh PIDFILE RUN_ROOT
#
# A trainer can hang without exiting (a collective waiting on a rank that died, a wedged
# card), which the supervisor (it watches exits) cannot see. Every live trainer of the port
# appends to a metrics.jsonl under its run root (MetricsLogger: every log_every steps and
# every validation). Every STALL_WINDOW seconds this loop finds the newest metrics.jsonl (or
# metrics.inflight.jsonl) under RUN_ROOT; when it has not grown for STALL_WINDOW seconds and
# the newest python process under the pid file's process is older than that, the process is
# killed (its exact pid, never a pattern), so that the supervisor relaunches it and training
# resumes from its latest checkpoint. A false positive costs one relaunch. Choose
# STALL_WINDOW above the longest quiet stretch of the run (a validation, a checkpoint).
# Exits when the pid file is gone. Log: STALL_LOG.
set -u
PIDFILE=${1:?usage: stall_watchdog.sh PIDFILE RUN_ROOT}
ROOT=${2:?usage: stall_watchdog.sh PIDFILE RUN_ROOT}
WINDOW=${STALL_WINDOW:-1800}
LOG=${STALL_LOG:-${TMPDIR:-/tmp}/stall_watchdog.log}

newest_py() {  # the newest python process in the tree under the pid file's process
  local pids all="" next p
  pids=$(cat "$PIDFILE" 2>/dev/null) || return 1
  while [ -n "$pids" ]; do
    next=""
    for p in $pids; do
      all="$all $p"
      next="$next $(ps -o pid= --ppid "$p" 2>/dev/null | tr '\n' ' ')"
    done
    pids=$(echo $next)
  done
  for p in $all; do
    case "$(ps -o comm= -p "$p" 2>/dev/null)" in python*) echo "$p";; esac
  done | tail -1
}

newest_metrics() {  # the mtime (s) of the newest metrics file under the run root
  find "$ROOT" \( -name metrics.jsonl -o -name metrics.inflight.jsonl \) -type f \
    -printf '%T@\n' 2>/dev/null | sort -n | tail -1 | cut -d. -f1
}

echo "stall_watchdog $$ watching $PIDFILE, metrics under $ROOT (window=${WINDOW}s)" >> "$LOG"
while true; do
  sleep "$WINDOW"
  [ -f "$PIDFILE" ] || { echo "pidfile gone; watchdog exiting $(date -u +%H:%M:%S)" >> "$LOG"; exit 0; }
  PY=$(newest_py) || continue
  [ -n "${PY:-}" ] || continue
  AGE=$(ps -o etimes= -p "$PY" 2>/dev/null | tr -d ' ') || continue
  [ -n "$AGE" ] || continue
  MTIME=$(newest_metrics)
  QUIET=$(( $(date +%s) - ${MTIME:-$(date +%s)} ))
  if [ "$QUIET" -ge "$WINDOW" ] && [ "$AGE" -ge "$WINDOW" ]; then
    echo "STALL: metrics under $ROOT silent ${QUIET}s, pid $PY age ${AGE}s; killing $(date -u +%H:%M:%S)" >> "$LOG"
    kill "$PY" 2>/dev/null
  fi
done
