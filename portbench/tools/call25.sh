#!/bin/sh
# Call 25: K-means tuned again at scale 25 and frozen, its limits' readings
# on 13 seeds a cell, and one trial run a cell, all under <out>.
#
#     sh portbench/tools/call25.sh <out>
set -u
sh portbench/tools/tune.sh "$1" e071f4a4a0d115092457a34e10acc0431f386436 "PR 36 call 25" portbench/tools/tune_call25.txt
cp "$1/tune/kmeans_s25.json" portbench/configs/kmeans.json || exit 1
sh portbench/tools/calibrate.sh "$1" cal25 7100000001 kmeans.proxy kmeans.proxy_torch
sh portbench/tools/sets.sh "$1" trial25 10 1 1 7200000001 kmeans.proxy kmeans.proxy_torch
