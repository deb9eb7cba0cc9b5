#!/bin/sh
# The exact count path of two trees on one card, back to back: parent,
# change, change, parent, each `chip_smoke.py --phases 2,3` with its own
# record file.  Run from the root of the change's tree:
#
#     sh chip_compare.sh PARENT_DIR OUT_DIR [TAG]
#
# PARENT_DIR holds an unpacked `git archive` of the parent commit; the four
# records go to OUT_DIR/TAG_{parent,change}_{1,2}.json (TAG defaults to k1).
set -e
parent=$(cd "$1" && pwd)
mkdir -p "$2"
out=$(cd "$2" && pwd)
tag=${3:-k1}
change=$(pwd)
for run in parent_1 change_1 change_2 parent_2; do
  case $run in parent*) dir=$parent ;; *) dir=$change ;; esac
  (cd "$dir" && python3 chip_smoke.py --phases 2,3 \
      --record "$out/${tag}_$run.json") | grep -E '^phase [23]'
done
