"""A needle eval's results JSON as an accuracy grid (context length ×
depth), the table form of the reference's heatmap.

The port's own copy of `lwm_tpu/apps/summarize_needle.py` (that module's
package imports JAX): the same grid and the same printed lines, for
`apps.eval_needle`'s and `apps.eval_needle_multi`'s results (a multi-needle
row is correct when every needle is).

Run: python -m lwm_tpu_torch.apps.summarize_needle results.json
"""

import json
import sys
from collections import defaultdict


def summarize(path):
    with open(path) as f:
        results = json.load(f)
    grid = defaultdict(list)
    multi = results and isinstance(results[0].get("correct"), list)
    for r in results:
        correct = all(r["correct"]) if isinstance(r["correct"], list) else r["correct"]
        depth = r.get("depth_percent", "all")
        grid[(r["context_length"], depth)].append(correct)

    lengths = sorted({k[0] for k in grid})
    depths = sorted({k[1] for k in grid}, key=lambda d: (d == "all", d))
    header = "ctx_len".ljust(10) + "".join(f"{str(d):>8}" for d in depths) + "     avg"
    print(("multi-needle " if multi else "") + "accuracy by (context length × depth %):")
    print(header)
    total_n = total_c = 0
    for length in lengths:
        row, row_c, row_n = [], 0, 0
        for d in depths:
            cell = grid.get((length, d))
            if cell:
                acc = sum(cell) / len(cell)
                row.append(f"{acc:>8.2f}")
                row_c += sum(cell)
                row_n += len(cell)
            else:
                row.append("       -")
        total_c += row_c
        total_n += row_n
        print(f"{length:<10}" + "".join(row) + f"{row_c / max(row_n, 1):>8.2f}")
    print(f"\noverall: {total_c}/{total_n} = {total_c / max(total_n, 1):.3f}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    summarize(argv[0] if argv else "results.json")


if __name__ == "__main__":
    main()
