#!/usr/bin/env bash
# BASELINE config #5 at its named scale on the port (benchmarks/run_r05.sh
# steps 3 and 4 for "loop", step 2 and its gt_init_ba for "eight"):
# 50,000 scans x 8,192 points through bench.scaled in one process, then
# bench.gt_init_ba on the run's graph dump.
#
#   icp_tpu_torch/bench/run_50k.sh loop|eight OUT_DIR [SCANS] [-- ARGS]
#
# SCANS: the run's length (default 50000); ARGS go to both entry points
# (e.g. --device cpu). bench.scaled's line goes to OUT_DIR/scaled_<traj>.json,
# gt_init_ba's to OUT_DIR/gt_init_ba_<traj>.json, the progress logs beside
# them; the dump (tmp/graph50k_torch_<traj>.npz) stays under tmp/. On one
# H100 a run takes about 48-53 minutes.
set -euo pipefail
traj=${1:?loop or eight}
out=${2:?output directory}
scans=${3:-50000}
shift $(( $# < 3 ? $# : 3 ))
[ "${1:-}" = "--" ] && shift
cd "$(dirname "$0")/../.."
mkdir -p "$out" tmp
dump=tmp/graph50k_torch_$traj.npz
BENCH_SCALED_SCANS=$scans BENCH_SCALED_POINTS=8192 BENCH_SCALED_TRAJ=$traj \
    BENCH_SCALED_DUMP_GRAPH=$dump python3 -m icp_tpu_torch.bench.scaled "$@" \
    > "$out/scaled_$traj.json" 2> "$out/scaled_$traj.log"
python3 -m icp_tpu_torch.bench.gt_init_ba "$dump" 15 "$@" \
    > "$out/gt_init_ba_$traj.json" 2> "$out/gt_init_ba_$traj.log"
