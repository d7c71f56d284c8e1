#!/usr/bin/env bash
# Parent against change on one card: the benchmark's cells, run from two
# checkouts in turn, so that both are measured on the same card in one call.
#
#   scripts/portbench_ab.sh PARENT_DIR OUT_DIR "CELL ..." "SEED ..." "TRACE_SEED ..."
#
# PARENT_DIR holds the parent commit's files (git archive), with this
# checkout's BENCHMARK.json and portbench/ laid over it; the change is the
# current directory. For each cell and each SEED the runs go parent, change,
# change, parent (--trace 0); then for each TRACE_SEED one traced run of each
# side (portbench/split.py, which also prints the span split). Every run's
# output lands in OUT_DIR/<n>.<side>.<cell>.<seed>.t<trace>.{out,err}, n
# counting the runs of the call; a summary line per run goes to stdout. The
# run length is BENCHMARK.json's.
set -u
parent=$(cd "$1" && pwd); out=$2; cells=$3; seeds=$4; trace_seeds=${5:-}
change=$(pwd)
mkdir -p "$out"; out=$(cd "$out" && pwd)
secs=$(python3 -c 'import json; print(json.load(open("BENCHMARK.json"))["run_seconds"])')
n=0

run() {  # side cell seed trace
    local dir=$parent script=portbench/run.py flags=(--trace 0)
    [ "$1" = change ] && dir=$change
    [ "$4" = 1 ] && script=portbench/split.py flags=()
    n=$((n + 1))
    local base="$out/$n.$1.$2.$3.t$4"
    (cd "$dir" && python3 "$script" --workload "$2" --seed "$3" --seconds "$secs" \
        "${flags[@]}" >"$base.out" 2>"$base.err")
    local rc=$?
    echo "$n $1 $2 $3 t$4 rc=$rc $(grep -o '"step_ms": {"value": [0-9.]*' "$base.out" | head -n 1)"
}

for cell in $cells; do
    for seed in $seeds; do
        for side in parent change change parent; do run "$side" "$cell" "$seed" 0; done
    done
    for seed in $trace_seeds; do
        for side in parent change; do run "$side" "$cell" "$seed" 1; done
    done
done
