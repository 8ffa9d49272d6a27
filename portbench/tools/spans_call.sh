#!/bin/sh
# The run spans on the card, and beside them the benchmark's own runs, all
# under <out>:
#
#     sh portbench/tools/spans_call.sh <out> <seed> [<parent>]
#
# In order: the cuda tests of the run spans; one short run that builds the
# kernels; then a cell at a time, tools/spans.py three times with --trace
# 0 runs of this tree between them, each on a seed of its own.
#
# With <parent>, a checkout of the parent commit with this tree's
# BENCHMARK.json and portbench/ laid over it, made beforehand:
#
#     rm -rf .archive_check/parent && mkdir -p .archive_check/parent \
#         && git archive <parent commit> | tar -x -C .archive_check/parent \
#         && cp -r BENCHMARK.json portbench .archive_check/parent/
#
# the tool runs twice a cell on this tree and once on the parent (whose
# runner has no spans: it has to fail with PhasesMissed), and then a cell
# at a time three pairs of --trace 0 runs and two of --trace 1, the sides
# in turns, the two sides of a pair on one seed.
set -u
out=$1 seed=$2 parent=${3:-}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
PYTHONPATH=src python3 -m pytest -q --noconftest -p no:cacheprovider -m cuda \
  tests/test_torch_run_spans.py 2>&1 | tail -n 5
python3 portbench/run.py --workload kmeans.proxy --seed "$seed" --seconds 1 \
  --trace 0 > "$out/warm.C.out" 2> "$out/warm.C.err"
echo "warm C rc=$?"

spans() {  # side dir cell seed
  f="$out/spans.$1.$3.$4"
  (cd "$2" && python3 portbench/tools/spans.py --workload "$3" --seed "$4") \
    > "$f.out" 2> "$f.err"
  echo "spans $1 $3 $4 rc=$? $(tail -n 1 "$f.err" | head -c 300)"
}
one() {  # side dir cell seed trace
  f="$out/$1.$3.$4.t$5"
  (cd "$2" && python3 portbench/run.py --workload "$3" --seed "$4" \
    --seconds 10 --trace "$5") > "$f.out" 2> "$f.err"
  echo "$1 $3 $4 trace=$5 rc=$? $(tail -n 1 "$f.out" | head -c 700)"
}
if [ -z "$parent" ]; then
  for cell in kmeans.proxy kmeans.proxy_torch; do
    s=$((seed + 1))
    spans C . "$cell" $s; one C . "$cell" $((s + 1)) 0
    spans C . "$cell" $((s + 2)); one C . "$cell" $((s + 3)) 0
    spans C . "$cell" $((s + 4))
  done
  exit 0
fi
cp -r src/repro_torch/kernels/_build "$parent/src/repro_torch/kernels/"
(cd "$parent" && python3 portbench/run.py --workload kmeans.proxy \
  --seed "$seed" --seconds 1 --trace 0) > "$out/warm.P.out" 2> "$out/warm.P.err"
echo "warm P rc=$?"
for cell in kmeans.proxy kmeans.proxy_torch; do
  spans C . "$cell" $((seed + 1))
  spans C . "$cell" $((seed + 2))
done
spans P "$parent" kmeans.proxy_torch $((seed + 3))
for cell in kmeans.proxy kmeans.proxy_torch; do
  s=$((seed + 10))
  one P "$parent" "$cell" $s 0; one C . "$cell" $s 0
  one C . "$cell" $((s + 1)) 0; one P "$parent" "$cell" $((s + 1)) 0
  one P "$parent" "$cell" $((s + 2)) 0; one C . "$cell" $((s + 2)) 0
  one C . "$cell" $((s + 3)) 1; one P "$parent" "$cell" $((s + 3)) 1
  one P "$parent" "$cell" $((s + 4)) 1; one C . "$cell" $((s + 4)) 1
done
