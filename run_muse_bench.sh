#!/bin/sh
# MUSE completion driver: resume-chain attempts until the final JSON metric
# line appears (tools/muse_run.py — no fixed attempt cap, adaptive dispatch
# shrink, global wall budget MUSE_RUN_BUDGET_S).
cd "$(dirname "$0")" || exit 1
exec python tools/muse_run.py "$1" muse_bench_out
