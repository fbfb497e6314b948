"""The readings that a cell's limits are set from, on the card.

    python -m port_bench.readings --workload <cell> --seeds 1,2,3 \
        --seconds 3 [--control N] [--trace] [--out FILE]

For each seed, one run of the cell as `port_bench.run` makes it (set-up, a
short window at the cell's own load, the check), in one process, and one
JSON line with the run's compared numbers (the program's reading) and, on
the first N seeds (all by default), the control's: the plain reference in
TF32, put in the program's place (its own start and stretch, its answers on
the same sampled states) and held against the reference in float32 (the
configuration states float32 with TF32 off). With `--trace` each run also
traces its frames and the line carries the trace's reduction. The lower
reading of a number is the largest the program gives over the seeds, the
upper the smallest the control gives; `PERF.md` records both beside each
limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .cells import load_cell
from .run import T_START, card_error, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=None,
                    help="the control on the first N seeds only")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    err = card_error(cell.chips)
    if err:
        print(f"port_bench.readings: {err}", file=sys.stderr)
        return 2
    lines = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        control = args.control is None or i < args.control
        out = run_cell(cell, seed, args.seconds, args.trace, control=control,
                       t_start=T_START if i == 0 else t)
        chk = out.pop("_check")
        line = {"workload": cell.name, "seed": seed,
                "program": chk["numbers"], "control": chk.get("control"),
                "per_frame": chk["per_frame"],
                "check_s": chk["seconds"], "correct": out["correct"],
                "attempted": out["attempted"], "metrics": out["metrics"],
                "device": out["device"], "run_s": time.perf_counter() - t}
        if args.trace:
            line["breakdown"] = out.get("breakdown")
            line["trace"] = out.get("_trace")
        lines.append(line)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(json.dumps(line) + "\n")
    for key in lines[0]["program"]:
        prog = [x["program"][key] for x in lines]
        ctrl = [x["control"][key] for x in lines if x["control"]]
        print(f"# {cell.name} {key}: program max {max(prog)!r}, "
              f"control min {min(ctrl, default=None)!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
