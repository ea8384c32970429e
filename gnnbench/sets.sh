# The runs a cell's bounds are set from, on the card, from the root of a
# checkout:  bash gnnbench/sets.sh <workload> <seed base> [<out dir>]
# One traced run first (a checkout's first run of a cell builds), two sets
# of 6 runs on the same 6 seeds, two more traced runs; each run's result
# line goes to <out dir>/sets_<workload>.{A,B,trace}.jsonl (default
# gnnbench/cache).  The cell is loaded first, as a run loads it (its
# configuration's reference module, its readers): one that cannot load
# makes no run.
W=$1; B=$2; D=${3:-gnnbench/cache}
S=$(python3 -c "
import json, sys
from pathlib import Path
sys.path.insert(0, '.')
from gnnbench import harness
harness.load_cell(Path('.'), sys.argv[1])
print(json.loads(Path('BENCHMARK.json').read_text())['run_seconds'])" "$W") || exit 1
O=$D/sets_$W; mkdir -p "$D"
run() { python3 gnnbench/run.py --workload $W --seed $1 --seconds $S --trace $2 > $O.tmp.out 2> $O.tmp.err; echo "rc=$? seed=$1 trace=$2 $(tail -n 5 $O.tmp.err | tr '\n' ' ' | cut -c1-400)"; tail -n 1 $O.tmp.out >> $3; }
run $((B + 101)) 1 $O.trace.jsonl
for set in A B; do for i in 1 2 3 4 5 6; do run $((B + i)) 0 $O.$set.jsonl; done; done
run $((B + 102)) 1 $O.trace.jsonl
run $((B + 103)) 1 $O.trace.jsonl
rm -f $O.tmp.out $O.tmp.err
