#!/usr/bin/env python3
"""Show that chip_smoke.py's autoresume check tells a sound resume from a
broken one, on the card.

    python3 scripts/check_train_resume.py

Runs chip_smoke.py's phases 10-11 (the train step, then the training CLI
with its round trip, printing their readings), three more sound round trips
(`chip_smoke.train_cli_round_trip`: the 7b width at 1 layer, A 2 steps and a
save, B the autoresume to 4, C 0 to 4), then two broken ones: AdamW's
moments zeroed on load, and its count reset to 0 on load. Each round trip
prints B's steps 3-4 against C's; the last line is a JSON object of each
one's verdict and largest relative differences. A sound round trip must pass
`ROUNDTRIP_RTOL` and a broken one must fail it; the script exits 1
otherwise. ~5 min of command on an H100.
"""

import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from lwm_tpu_torch import optim  # noqa: E402


def round_trip(what):
    """(passed, readings) of one round trip in a fresh directory."""
    with tempfile.TemporaryDirectory(prefix="lwm_resume_") as tmp:
        try:
            return True, cs.train_cli_round_trip(Path(tmp), what)[1]
        except AssertionError as e:
            cs.log(f"{what}: the check failed: {e.args[0]}")
            return False, e.args[1]


def main():
    cs.phase_env()
    cs.phase_build()
    t0 = time.perf_counter()
    _, step_s_full = cs.phase_train_full()
    cs.phase_train_cli(step_s_full)
    cs.log(f"phases 10-11 in {time.perf_counter() - t0:.1f}s")
    out = {f"sound {i}": round_trip(f"sound round trip {i}") for i in (2, 3, 4)}
    load = optim.AdamW.load_named_state

    def moments_zeroed(self, named):
        load(self, named)
        for p in self._params():
            for k in ("mu", "nu"):
                self.state[p][k].zero_()

    def count_reset(self, named):
        load(self, named)
        self.count = 0

    for name, broken in (("moments zeroed", moments_zeroed), ("count reset", count_reset)):
        optim.AdamW.load_named_state = broken
        try:
            out[name] = round_trip(f"round trip, AdamW {name} on load")
        finally:
            optim.AdamW.load_named_state = load
    print(json.dumps(out))
    wrong = [k for k, (passed, _) in out.items() if passed != k.startswith("sound")]
    if wrong:
        raise SystemExit(f"check_train_resume: the check misjudged {wrong}")


if __name__ == "__main__":
    main()
