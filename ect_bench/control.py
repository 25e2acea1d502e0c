"""The readings the limits of ``correct`` are set from, for one cell.

    python3 -m ect_bench.control --workload <name> --seconds <s> \\
        --program-seeds <n>... --control-seeds <n>...

runs, in one process on the card, the cell at its own size with a short
window once per seed: first the program as the configuration states it
(the lower readings), then the control, the program with the
configuration's ``control`` knobs (a table-log policy that picks smaller,
faster tables than the configuration states: the step that would tempt a
later change), which breaks the guarantee that the frame is the
configuration's frame (the upper readings). Each run's numbers compared are
printed as a JSON line; the last line gives, per number, the largest
reading of the program and the smallest of the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def readings(bench, cell, seeds, seconds, overrides, device="cuda",
             root=None, log=print) -> list[dict]:
    """One short run of ``cell`` per seed; each run's checks."""
    from . import harness, registry

    root = root or registry.HERE
    out = []
    for seed in seeds:
        t0 = time.monotonic()
        res = harness.run_cell(bench, cell, seed, seconds, False, device,
                               root=root, overrides=overrides,
                               log=lambda s: None)
        row = {"seed": seed, "control": overrides is not None,
               "correct": res["correct"], "attempted": res["attempted"],
               "checks": {k: v["value"] for k, v in res["checks"].items()},
               "seconds": round(time.monotonic() - t0, 3)}
        log(json.dumps(row))
        out.append(row)
    return out


def summary(program: list[dict], control: list[dict]) -> dict:
    """Per number compared: the program's largest reading (lower) and the
    control's smallest (upper)."""
    names = sorted({k for r in program + control for k in r["checks"]})
    return {k: {"lower": max((r["checks"][k] for r in program
                              if k in r["checks"]), default=None),
                "upper": min((r["checks"][k] for r in control
                              if k in r["checks"]), default=None)}
            for k in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ect_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    from . import harness, registry

    bench = registry.load()
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(cell.config)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    program = readings(bench, cell, args.program_seeds, args.seconds, None)
    control = readings(bench, cell, args.control_seeds, args.seconds,
                       cfg["control"])
    print(json.dumps({"workload": cell.name, "control": cfg["control"],
                      "readings": summary(program, control)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
