"""The benchmark's command: one run of one cell on the card.

    python -m perfbench --workload le100k.loop --seed 7 --seconds 10 --trace 0

Prints the compared numbers with their limits as the last lines of
standard error and one JSON line, the result, as the last line of
standard output.  Exits 2 without printing a result when the card is
missing or when, after the window, a module of JAX or of the JAX package
is loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def parse(argv):
    ap = argparse.ArgumentParser(prog="python -m perfbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    import torch

    from perfbench import harness, spec

    work = spec.workload(args.workload)
    chips = next((w["chips"] for w in spec.benchmark()["workloads"]
                  if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: cell {args.workload} needs {chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # the program's kernel libraries build into its own build directory
    # inside the checkout (lammps_le_torch/build); nothing else is cached
    torch.set_num_threads(1)
    line, rows = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start, work=work)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: modules loaded that the run must not load: "
              f"{bad}", file=sys.stderr)
        return 2
    for name, val, lim, ok in rows:
        print(f"check {name} {val!r} limit {lim!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
