#!/bin/sh
# Some phases of two trees on one card, back to back: parent, change,
# change, parent, each `chip_smoke.py --phases PHASES` with its own record
# file.  Run from the root of the change's tree:
#
#     sh chip_compare.sh PARENT_DIR OUT_DIR [TAG] [PHASES] [EXTRA]
#
# PARENT_DIR holds an unpacked `git archive` of the parent commit; the four
# records go to OUT_DIR/TAG_{parent,change}_{1,2}.json (TAG defaults to k1,
# PHASES to 2,3: the exact count path; `k2 7,8` compares the per-cell
# kernel and the cell engine).  EXTRA, a command, runs after the phases in
# each tree's root (e.g. "python3 $PWD/tools/tail_exact_chunk.py").
set -e
parent=$(cd "$1" && pwd)
mkdir -p "$2"
out=$(cd "$2" && pwd)
tag=${3:-k1}
phases=${4:-2,3}
extra=${5:-}
pattern="^(card|phase ($(echo "$phases" | tr , '|'))[ :])"
change=$(pwd)
for run in parent_1 change_1 change_2 parent_2; do
  case $run in parent*) dir=$parent ;; *) dir=$change ;; esac
  echo "== $run"
  (cd "$dir" && python3 chip_smoke.py --phases "$phases" \
      --record "$out/${tag}_$run.json") | grep -E "$pattern"
  if [ -n "$extra" ]; then (cd "$dir" && $extra); fi
done
