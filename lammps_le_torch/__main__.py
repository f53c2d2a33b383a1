"""Command-line entry point — the ``lmp -in deck`` analog
(``lammps_le_tpu/__main__.py``; reference: src/main.cpp:34-53).

    python -m lammps_le_torch -in in.chain [-var name value ...] \
        [-log log.txt] [-dtype float32|float64] [-quiet] [-platform gpu|cpu]

``-platform gpu`` (the default) runs the deck on the card and fails
without one; ``-platform cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="lammps_le_torch")
    ap.add_argument("-in", dest="infile", required=True,
                    help="input deck (LAMMPS script subset)")
    ap.add_argument("-var", dest="vars", nargs=2, action="append",
                    default=[], metavar=("NAME", "VALUE"),
                    help="deck variable (like lmp -var)")
    ap.add_argument("-log", dest="log", default=None)
    ap.add_argument("-dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("-quiet", action="store_true")
    ap.add_argument("-platform", default="gpu", choices=["gpu", "cpu"],
                    help="run on the card (gpu, the default) or the CPU")
    args = ap.parse_args(argv)

    from .deck import DeckRunner

    runner = DeckRunner(dtype=args.dtype, quiet=args.quiet,
                        device="cuda" if args.platform == "gpu" else "cpu")
    if args.log:
        runner.command("log", [args.log])
    runner.run_file(args.infile, variables=dict(args.vars))
    return 0


if __name__ == "__main__":
    sys.exit(main())
