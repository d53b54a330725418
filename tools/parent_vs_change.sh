#!/usr/bin/env bash
# This checkout against another (its parent commit, say) on one CUDA card, in
# one call, so both run on the same card at the same power limit:
# chip_smoke.py in the order parent, change, change, parent, then
# tools/profile_prove.py (one warm prove under torch.profiler) on each tree.
#
#   mkdir -p scratch/parent && git archive <parent commit> | tar -x -C scratch/parent
#   bash tools/parent_vs_change.sh scratch/parent [OUT_DIR]
#
# Each run's full output goes to OUT_DIR (default outputs/parent_vs_change/) as
# parent1.log, change1.log, change2.log, parent2.log, profile_change.log and
# profile_parent.log; stdout gets the card's name and power limit, each run's
# exit code and seconds, and the lines of each log that carry the numbers.
set -u
HERE=$(cd "$(dirname "$0")/.." && pwd)
PARENT=$(cd "${1:?usage: parent_vs_change.sh PARENT_DIR [OUT_DIR]}" && pwd)
OUT=$(mkdir -p "${2:-$HERE/outputs/parent_vs_change}" && cd "${2:-$HERE/outputs/parent_vs_change}" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
fail=0
run() {  # run NAME DIR COMMAND...
  local name=$1 dir=$2 t0=$SECONDS rc
  shift 2
  (cd "$dir" && "$@") >"$OUT/$name.log" 2>&1
  rc=$?
  echo "$name rc=$rc $((SECONDS - t0)) s"
  [ $rc -eq 0 ] || fail=1
}
run parent1 "$PARENT" python3 chip_smoke.py
run change1 "$HERE" python3 chip_smoke.py
run change2 "$HERE" python3 chip_smoke.py
run parent2 "$PARENT" python3 chip_smoke.py
run profile_change "$HERE" python3 tools/profile_prove.py
run profile_parent "$HERE" python3 tools/profile_prove.py --root "$PARENT"
for name in parent1 change1 change2 parent2; do
  echo "== $name"
  grep -E '^phase (1 build|3|4 setup|4 prove)|^  K1 FR |^all phases' "$OUT/$name.log"
done
for name in profile_change profile_parent; do
  echo "== $name"
  tail -n 1 "$OUT/$name.log" | cut -c 1-900
done
exit $fail
