"""Run some of chip_smoke.py's phases on the card, in order, after its
environment check and kernel build:

    python3 scripts/run_phases.py [--root DIR] NAMES

NAMES: comma-separated, each the phase chip_smoke.phase_<NAME> (given the
seed's generator when it takes an argument), e.g. `head_dims,3b` or `k56`;
each phase of the list that the checkout has runs, and one at least must (a
phase renamed between two checkouts: `bwd,k23`). DIR: the checkout whose
chip_smoke.py, package and kernels run (default: this one's); each builds
its own kernels into its own lwm_tpu_torch/_build/. A phase that takes a
model or another phase's result (the serving modes, the mesh phases) is not
run this way. scripts/compare_phase.sh runs this for two checkouts in turns.
"""
import argparse
import os
import sys
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("names", help="comma-separated phase names, e.g. head_dims,3b")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    os.chdir(root)
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as c

    fns = [getattr(c, "phase_" + name) for name in args.names.split(",")
           if hasattr(c, "phase_" + name)]
    if not fns:
        raise SystemExit(f"no phase {args.names} in {c.__file__}")
    c.phase_env()
    c.phase_build()
    gen = torch.Generator(device="cuda").manual_seed(c.SEED)
    for fn in fns:
        fn(gen) if fn.__code__.co_argcount else fn()   # phase_serve and phase_3b take none


if __name__ == "__main__":
    main()
