#!/bin/sh
# The readings each cell's limits are set from (portbench/calibrate.py),
# on a dozen seeds and one, one process a cell; each cell's lines go to
# <out>/<tag>/<cell>.out and its last line to standard output.
#
#     sh portbench/tools/calibrate.sh <out> <tag> <seed> cell...
set -u
out=$1/$2 seed=$3
shift 3
mkdir -p "$out"
for cell in "$@"; do
  python3 portbench/calibrate.py --workload "$cell" \
    --seeds $(seq "$seed" $((seed + 12))) > "$out/$cell.out" 2> "$out/$cell.err"
  echo "$cell rc=$? $(tail -n 1 "$out/$cell.out")"
done
