"""A vision-needle results JSON (`apps.eval_vision_needle`) as a grid of
frame count × depth, each cell correct/total.

The port's own copy of `lwm_tpu/apps/summarize_vision_needle.py` (that
module's package imports JAX): the same grid and the same printed lines,
character for character.

Run: python -m lwm_tpu_torch.apps.summarize_vision_needle RESULTS.json
"""

import json
import sys
from collections import defaultdict


def summarize(path):
    with open(path) as f:
        results = json.load(f)
    grid = defaultdict(lambda: [0, 0])
    lengths, depths = set(), set()
    for row in results.values():
        key = (row["n_frames"], row["depth_pct"])
        grid[key][0] += int(row["correct"])
        grid[key][1] += 1
        lengths.add(row["n_frames"])
        depths.add(row["depth_pct"])
    lengths, depths = sorted(lengths), sorted(depths)
    print("frames(vis-toks)" + "".join(f"  d{d:>3}%" for d in depths))
    tot_c = tot_n = 0
    for fr in lengths:
        vt = next(r["vision_tokens"] for r in results.values() if r["n_frames"] == fr)
        cells = []
        row_c = row_n = 0
        for d in depths:
            c, n = grid[(fr, d)]
            cells.append(f"  {c}/{n:<3}")
            row_c += c
            row_n += n
        tot_c += row_c
        tot_n += row_n
        print(f"{fr:>4} ({vt:>6})  " + "".join(cells)
              + f"   = {row_c}/{row_n} ({row_c / max(row_n, 1):.0%})")
    print(f"total: {tot_c}/{tot_n} = {tot_c / max(tot_n, 1):.1%}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    summarize(argv[0])


if __name__ == "__main__":
    main()
