#!/bin/sh
# The runs a cell's bounds are set from: for each cell named, two sets of
# runs on the same seeds (set A, then set B), then traced runs on further
# seeds, each a process of its own as the benchmark's check starts them.
# Every run's output and errors go to <out>/<tag>/; one line a run on
# standard output.  portbench/tools/spread.py reads them.
#
#     sh portbench/tools/sets.sh <out> <tag> <seconds> <runs> <traced> <seed> cell...
set -u
out=$1/$2 seconds=$3 runs=$4 traced=$5 seed=$6
shift 6
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader
one() {  # cell set seed trace
  f="$out/$1.$2.$3"
  python3 portbench/run.py --workload "$1" --seed "$3" --seconds "$seconds" \
    --trace "$4" > "$f.out" 2> "$f.err"
  echo "$1 $2 $3 trace=$4 rc=$? $(tail -n 1 "$f.out" | head -c 600)"
}
for cell in "$@"; do
  for set in A B; do
    i=0
    while [ "$i" -lt "$runs" ]; do
      one "$cell" "$set" $((seed + i)) 0
      i=$((i + 1))
    done
  done
  i=0
  while [ "$i" -lt "$traced" ]; do
    one "$cell" T $((seed + runs + i)) 1
    i=$((i + 1))
  done
done
