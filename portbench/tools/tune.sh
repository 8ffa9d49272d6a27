#!/bin/sh
# Tune workloads' proxies on the card at the settings a list file gives,
# one attempt a line (label, workload, scale, iterations, substrate), and
# keep every attempt under <out>/tune/: <label>.log, and the configuration
# as <label>.json, ready to be copied into portbench/configs/ (its
# provenance says whether the tuner qualified it; rc=1 when not).
#
#     sh portbench/tools/tune.sh <out> <commit> <chip call> <list file>
set -u
out=$1/tune
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
while read -r label workload scale iters substrate; do
  timeout 900 python3 portbench/freeze.py --workload "$workload" \
    --scale "$scale" --max-iters "$iters" --substrate "$substrate" \
    --commit "$2" --call "$3" --out "$out/$label.json" \
    > "$out/$label.log" 2>&1
  echo "$label rc=$?"
  head -c 1500 "$out/$label.log"; echo
done < "$4"
