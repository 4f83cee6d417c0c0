#!/usr/bin/env bash
# Run one chip_smoke.py phase from two checkouts on one card, in turns:
# other, this, this, other. The card's clocks and neighbours differ from one
# machine to the next, so two versions are compared only inside one run.
#
#   scripts/compare_phase.sh DIR NAMES
#
# DIR: the other checkout's root, e.g. a commit unpacked under the
#      gitignored _checkout/ (git archive <commit> | tar -x -C _checkout/x).
# NAMES: the phase as chip_smoke.phase_<NAME> (given the seed's generator
#      when it takes an argument); of a comma-separated list, each phase
#      that the checkout has runs, in order, and one at least must (two
#      phases: f32_kernels,bwd_f32; a phase renamed between the two
#      checkouts: bwd,k23).
# Each checkout builds its own kernels into its own lwm_tpu_torch/_build/
# (scripts/run_phases.py runs the phases).
set -euo pipefail
other=$(cd "$1" && pwd)
this=$(cd "$(dirname "$0")/.." && pwd)
names=$2
for root in "$other" "$this" "$this" "$other"; do
  echo "=== $root: phase $names"
  python3 "$this/scripts/run_phases.py" --root "$root" "$names"
done
