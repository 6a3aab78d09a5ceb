"""HBM fit report over the dry-run records (``repro.launch.fitcheck``).

    PYTHONPATH=src python -m repro_torch.launch.fitcheck [--budget-gib 80]
        [--tag pod1|pod2]

For each cell traced by ``launch.dryrun``: resident bytes a card
(arguments, plus outputs past those that take the place of donated
arguments) against the budget, which defaults to ``launch.mesh.HBM_BYTES``
(an H100's 80 GB), as ``repro`` reckons it; then the step's peak
temporary bytes, and the peak (resident plus temporaries) against the
same budget.  The peak is what the port's program needs while a step
runs; it is a model (nothing is fused, and a CPU-traced cell's
temporaries are those of its plain versions), so its verdict is
printed, and the exit code is ``repro``'s: non-zero if any cell's
resident state exceeds the budget.
"""
from __future__ import annotations

import argparse
import json
import pathlib

from .mesh import HBM_BYTES

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" \
    / "dryrun_torch"


def resident(mem: dict) -> int:
    """Arguments plus the outputs that do not alias a donated argument."""
    args_b = mem["argument_bytes"] or 0
    out_b = mem["output_bytes"] or 0
    alias_b = mem["alias_bytes"] or 0
    return args_b + max(0, out_b - alias_b)


def rows(tag: str, budget: float, results=RESULTS) -> list:
    """``(arch, shape, resident, temp, fits, peak fits)`` for every
    record of ``tag``."""
    out = []
    for p in sorted(pathlib.Path(results).glob(f"*__{tag}.json")):
        r = json.loads(p.read_text())
        res = resident(r["memory"])
        temp = r["memory"]["temp_bytes"] or 0
        out.append((r["arch"], r["shape"], res, temp, res <= budget,
                    res + temp <= budget))
    return out


def main(argv=None, results=RESULTS) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget-gib", type=float, default=HBM_BYTES / 2 ** 30)
    ap.add_argument("--tag", default="pod1")
    args = ap.parse_args(argv)

    budget = args.budget_gib * 2 ** 30
    table = rows(args.tag, budget, results)
    print(f"{'arch':34s}{'shape':16s}{'resident GiB':>13s}"
          f"{'temp GiB':>12s}{'peak GiB':>12s}  peak  fit")
    bad = peak_bad = 0
    for arch, shape, res, temp, ok, peak_ok in table:
        bad += 0 if ok else 1
        peak_bad += 0 if peak_ok else 1
        print(f"{arch:34s}{shape:16s}{res / 2**30:13.2f}"
              f"{temp / 2**30:12.2f}{(res + temp) / 2**30:12.2f}  "
              f"{'OK  ' if peak_ok else 'OVER'}  {'OK' if ok else 'OVER'}")
    print(f"\n{len(table) - bad}/{len(table)} cells fit "
          f"{args.budget_gib:.0f} GiB resident budget ({args.tag}); "
          f"{len(table) - peak_bad}/{len(table)} with their peak "
          f"temporaries")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
