"""Crash-resilient MUSE completion driver.

A long run that dies (a device fault, a killed process) loses its
in-flight dispatches but not the checkpoint chain (tools/muse_bench.py
checkpoints every CKPT_EVERY chunks). This script runs muse_bench.py
attempts in subprocesses, one at a time, until the final JSON metric line
appears, with:

- NO fixed attempt cap: retries are bounded by a global wall budget
  (MUSE_RUN_BUDGET_S, default 4 h);
- adaptive dispatch shrink: repeated fast crashes halve the dispatch-length
  target (MUSE_BENCH_DISPATCH_TARGET, a traced operand — retuning costs no
  recompiles) down to a 3 s floor; survivable attempts restore it;
- warm restarts: the persistent XLA compilation cache
  (massivedatans_tpu.utils.cache) is shared across attempts, so a retry
  re-pays cache lookups, not the compiles;
- crash forensics: every attempt's tail is appended to the log with the
  crash classification (worker-crash / timeout / other), and the attempt
  history is written next to the output as ``attempts_<N>.json``.

Usage:  python tools/muse_run.py [n_spaxels] [out_dir]
Prints muse_bench.py's JSON metric line on success (exit 0); exits 1 if the
wall budget runs out first.
"""

import json
import os
import signal
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N = int(sys.argv[1]) if len(sys.argv) > 1 else 100
OUT = sys.argv[2] if len(sys.argv) > 2 else "muse_bench_out"
BUDGET_S = float(os.environ.get("MUSE_RUN_BUDGET_S", "14400"))
ATTEMPT_TIMEOUT = int(os.environ.get("MUSE_ATTEMPT_TIMEOUT", "3500"))
TARGET0 = float(os.environ.get("MUSE_BENCH_DISPATCH_TARGET", "12"))
TARGET_FLOOR = 3.0
# an attempt that survives under this is a "fast crash" -> shrink dispatches
FAST_CRASH_S = float(os.environ.get("MUSE_RUN_FAST_CRASH_S", "240"))

WORKER_CRASH_MARKS = (
    "UNAVAILABLE",
    "DataLoss",
    "CUDA_ERROR",
    "illegal memory access",
)
# a hung device call blocks forever — kill an attempt whose log stops
# growing for this long. Must comfortably exceed one compile.
STALL_S = float(os.environ.get("MUSE_RUN_STALL_S", "900"))


def classify(tail: str, rc: int, dur: float) -> str:
    if rc in (124, -15, -9):
        return "timeout"
    for m in WORKER_CRASH_MARKS:
        if m in tail:
            return "worker-crash"
    return f"exit-{rc}"


def run_attempt(cmd, lf, env, timeout_s: float, log_path: str):
    """Run one attempt under BOTH an overall timeout and a log-stall
    watchdog; returns (rc, outcome_hint). Kills the exact process group
    this call created (never pattern-based)."""
    proc = subprocess.Popen(cmd, stdout=lf, stderr=subprocess.STDOUT,
                            env=env, start_new_session=True)
    t0 = time.time()
    hint = None
    while True:
        try:
            rc = proc.wait(timeout=10)
            return rc, hint
        except subprocess.TimeoutExpired:
            pass
        now = time.time()
        try:
            log_age = now - os.path.getmtime(log_path)
        except OSError:
            log_age = 0.0
        if now - t0 > timeout_s or log_age > STALL_S:
            hint = "stall" if log_age > STALL_S else "timeout"
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            try:
                return proc.wait(timeout=30), hint
            except subprocess.TimeoutExpired:
                return -9, hint


def main() -> int:
    t0 = time.time()
    target = TARGET0
    attempts = []
    log_path = f"muse_bench_{N}.log"
    hist_path = os.path.join(OUT, f"attempts_{N}.json")
    # truncate once per driver invocation so a stale metric line from a
    # previous completed run can never fake a success
    open(log_path, "w").close()

    i = 0
    while time.time() - t0 < BUDGET_S:
        i += 1
        env = dict(os.environ)
        env["MUSE_BENCH_DISPATCH_TARGET"] = f"{target:g}"
        left = BUDGET_S - (time.time() - t0)
        tmo = max(60, min(ATTEMPT_TIMEOUT, int(left)))
        with open(log_path, "a") as lf:
            lf.write(f"==== {time.strftime('%H:%M:%S')} attempt {i} "
                     f"(dispatch_target={target:g}s timeout={tmo}s) ====\n")
            lf.flush()
            t_a = time.time()
            rc, kill_hint = run_attempt(
                [sys.executable, os.path.join(HERE, "muse_bench.py"),
                 str(N), OUT],
                lf, env, tmo, log_path,
            )
            dur = time.time() - t_a

        with open(log_path) as lf:
            tail = lf.read()[-8000:]
        metric = None
        for line in tail.splitlines():
            if line.startswith("{") and '"metric"' in line:
                metric = line
        if rc == 0 and metric:
            attempts.append(dict(attempt=i, rc=rc, dur_s=round(dur, 1),
                                 outcome="completed", target_s=target))
            with open(hist_path, "w") as fh:
                json.dump(attempts, fh, indent=1)
            print(metric)
            return 0

        outcome = kill_hint or classify(tail, rc, dur)
        attempts.append(dict(attempt=i, rc=rc, dur_s=round(dur, 1),
                             outcome=outcome, target_s=target))
        with open(hist_path, "w") as fh:
            json.dump(attempts, fh, indent=1)
        # adaptive dispatch-length policy: fast device crashes suggest the
        # dispatches are too long -> shrink; a long
        # survivable attempt means the setting is fine -> restore toward
        # the configured target
        if outcome == "worker-crash" and dur < FAST_CRASH_S:
            target = max(TARGET_FLOOR, target / 2.0)
        elif dur > 3 * FAST_CRASH_S:
            target = min(TARGET0, target * 1.5)
        sys.stderr.write(
            f"[muse_run] attempt {i}: {outcome} after {dur:.0f}s "
            f"(next dispatch_target={target:g}s, "
            f"{BUDGET_S - (time.time() - t0):.0f}s left)\n")
        time.sleep(10 if outcome == "worker-crash" else 20)

    sys.stderr.write(f"[muse_run] wall budget {BUDGET_S:.0f}s exhausted "
                     f"after {len(attempts)} attempts\n")
    return 1


if __name__ == "__main__":
    sys.exit(main())
