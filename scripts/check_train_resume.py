#!/usr/bin/env python3
"""Show that chip_smoke.py's autoresume checks tell a sound resume from a
broken one, on the card.

    python3 scripts/check_train_resume.py            # the text CLI
    python3 scripts/check_train_resume.py vision [LR ...]

Text: runs chip_smoke.py's phases 10-11 (the train step, then the training
CLI with its round trip, printing their readings), three more sound round
trips (`chip_smoke.train_cli_round_trip`: the 7b width at 1 layer, A 2
steps and a save, B the autoresume to 4, C 0 to 4), then two broken ones:
AdamW's moments zeroed on load, and its count reset to 0 on load. ~5 min
of command on an H100.

Vision: at each PaLM lr (chip_smoke.VISION_ROUNDTRIP_LR when none is
given), two sound round trips of `chip_smoke.train_vision_round_trip`
(--freeze_base, PaLM, vte and vision_head held at step 4), then three
broken ones: PaLM's ema dropped on load, its v dropped, its count reset to
0. ~40 s of command an lr after the build.

Each round trip prints B's steps 3-4 against C's; the last line is a JSON
object of each one's verdict and largest relative differences. A sound
round trip must pass its limits and a broken one must fail them; the
script exits 1 otherwise.
"""

import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from lwm_tpu_torch import optim  # noqa: E402


def round_trip(what, run=cs.train_cli_round_trip):
    """(passed, readings) of one round trip in a fresh directory."""
    with tempfile.TemporaryDirectory(prefix="lwm_resume_") as tmp:
        try:
            return True, run(Path(tmp), what)[1]
        except AssertionError as e:
            cs.log(f"{what}: the check failed: {e.args[0]}")
            return False, e.args[1]


def broken_on_load(cls, name):
    """A `load_named_state` of `cls` that breaks the loaded state: "moments
    zeroed" (every key of cls.MOMENTS), "<moment> dropped" (one key left
    unset, as a state without it loads) or "count reset" (to 0)."""
    load = cls.load_named_state

    def broken(self, named):
        load(self, named)
        if name == "count reset":
            self.count = 0
        for p in self.params:
            if name == "moments zeroed":
                for key in cls.MOMENTS:
                    self.state[p][key].zero_()
            elif name.endswith(" dropped"):
                del self.state[p][name.split()[0]]

    return broken


def judge(out):
    print(json.dumps(out))
    wrong = [k for k, (passed, _) in out.items() if passed != k.startswith("sound")]
    if wrong:
        raise SystemExit(f"check_train_resume: the check misjudged {wrong}")


def check(out, cls, broken_names, run, label=""):
    for name in broken_names:
        load = cls.load_named_state
        cls.load_named_state = broken_on_load(cls, name)
        try:
            out[f"{label}{name}"] = round_trip(
                f"round trip{label and ' ' + label.strip()}, {cls.__name__} {name} on load", run)
        finally:
            cls.load_named_state = load


def text():
    cs.phase_env()
    cs.phase_build()
    t0 = time.perf_counter()
    _, step_s_full = cs.phase_train_full()
    cs.phase_train_cli(step_s_full)
    cs.log(f"phases 10-11 in {time.perf_counter() - t0:.1f}s")
    out = {f"sound {i}": round_trip(f"sound round trip {i}") for i in (2, 3, 4)}
    check(out, optim.AdamW, ("moments zeroed", "count reset"), cs.train_cli_round_trip)
    judge(out)


def vision(lrs):
    cs.phase_env()
    cs.phase_build()
    out = {}
    for lr in lrs or [cs.VISION_ROUNDTRIP_LR]:
        def run(tmp, what, lr=lr):
            data = tmp / "vision.jsonl"
            cs._write_vision_jsonl(data, cs.VISION_TRAIN_LINES, cs.SEED + 9)
            return cs.train_vision_round_trip(tmp, data, f"{what} at lr {lr}", lr)

        for i in (1, 2):
            out[f"sound {i} lr {lr}"] = round_trip(f"sound vision round trip {i}", run)
        check(out, optim.Palm, ("ema dropped", "v dropped", "count reset"), run, f"lr {lr} ")
    judge(out)


def main(argv):
    if argv[:1] == ["vision"]:
        vision([float(x) for x in argv[1:]])
    else:
        text()


if __name__ == "__main__":
    main(sys.argv[1:])
