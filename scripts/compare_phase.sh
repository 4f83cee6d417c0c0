#!/usr/bin/env bash
# Run one chip_smoke.py phase from two checkouts on one card, in turns:
# other, this, this, other. The card's clocks and neighbours differ from one
# machine to the next, so two versions are compared only inside one run.
#
#   scripts/compare_phase.sh DIR NAMES
#
# DIR: the other checkout's root, e.g. a commit unpacked under the
#      gitignored _checkout/ (git archive <commit> | tar -x -C _checkout/x).
# NAMES: the phase as chip_smoke.phase_<NAME>; a comma-separated list is
#      tried in order in each checkout (a phase renamed between the two:
#      bwd,k23).
# Each checkout builds its own kernels into its own lwm_tpu_torch/_build/.
set -euo pipefail
other=$(cd "$1" && pwd)
this=$(cd "$(dirname "$0")/.." && pwd)
names=$2
for root in "$other" "$this" "$this" "$other"; do
  echo "=== $root: phase $names"
  (cd "$root" && python3 - "$names" <<'PY'
import sys

import torch

import chip_smoke as c

c.phase_env()
c.phase_build()
gen = torch.Generator(device="cuda").manual_seed(c.SEED)
for name in sys.argv[1].split(","):
    fn = getattr(c, "phase_" + name, None)
    if fn is not None:
        fn(gen)
        break
else:
    raise SystemExit(f"no phase {sys.argv[1]} in {c.__file__}")
PY
  )
done
