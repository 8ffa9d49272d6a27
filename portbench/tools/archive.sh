#!/bin/sh
# Runs a cell twice from .archive_check/tree, a checkout made of what git
# would commit, and once from .archive_check/bare, which holds only
# BENCHMARK.json and the benchmark's own files (that run has to fail and
# print no result).  Made beforehand, on the host that calls the chip:
#
#     git add -A && rm -rf .archive_check && mkdir -p .archive_check/tree \
#         .archive_check/bare && git archive $(git write-tree) \
#         | tar -x -C .archive_check/tree && cp -r \
#         .archive_check/tree/BENCHMARK.json .archive_check/tree/portbench \
#         .archive_check/bare/
#
#     sh portbench/tools/archive.sh <out> <cell> <seed>
set -u
mkdir -p "$1"
out=$(cd "$1" && pwd)
cd .archive_check/tree || exit 1
for s in "$3" $(($3 + 1)); do
  python3 portbench/run.py --workload "$2" --seed "$s" --seconds 10 \
    --trace 0 > "$out/archive.$s.out" 2> "$out/archive.$s.err"
  echo "tree $s rc=$? $(tail -n 1 "$out/archive.$s.out" | head -c 700)"
done
ls -d .portbench_cache/* src/repro_torch/kernels/_build 2>&1 | head
cd ../bare || exit 1
python3 portbench/run.py --workload "$2" --seed "$3" --seconds 10 --trace 0 \
  > "$out/bare.out" 2> "$out/bare.err"
echo "bare rc=$? stdout_bytes=$(wc -c < "$out/bare.out") $(tail -n 1 "$out/bare.err")"
