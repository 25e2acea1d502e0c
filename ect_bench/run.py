"""Run one cell of the benchmark once.

    python3 -m ect_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic and
metrics are found by name from ``BENCHMARK.json`` (``registry``). The last
line of standard output is the result as one JSON object; the last lines
of standard error are the numbers compared, each beside its limit.

It exits non-zero, and prints no result, where CUDA is missing or has
fewer cards than the cell asks for, where the port is not the checkout's
own, and where JAX or the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """This process's start on ``time.monotonic``'s clock (now, where
    /proc does not say)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        up = float(Path("/proc/uptime").read_text().split()[0])
        return time.monotonic() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.monotonic()


def main(argv=None) -> int:
    t_start = _process_start()
    ap = argparse.ArgumentParser(prog="python3 -m ect_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import harness, registry

    bench = registry.load()
    cell = registry.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found {have}",
              file=sys.stderr)
        return 2
    root = registry.HERE.parent
    try:
        import entropy_coders_tpu_torch as port
    except ImportError as e:
        print(f"the port is missing from this checkout: {e}", file=sys.stderr)
        return 2
    if Path(port.__file__).resolve().parent.parent != root:
        print(f"the port loaded from {port.__file__}, not from {root}",
              file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(bench, cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda", t_start)
    except harness.ForbiddenModules as e:
        print(e, file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:
        print("loaded modules that a run must not load: " + ", ".join(found),
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
