#!/bin/sh
# Call 26: both cells' two sets of 6 runs and 3 traced runs, then the
# archive check (portbench/tools/archive.sh), all under <out>.
#
#     sh portbench/tools/call26.sh <out>
set -u
sh portbench/tools/sets.sh "$1" sets26 10 6 3 7300000001 kmeans.proxy kmeans.proxy_torch
sh portbench/tools/archive.sh "$1" kmeans.proxy 7400000001
