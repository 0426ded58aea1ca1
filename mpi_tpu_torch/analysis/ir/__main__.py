"""CLI for the launch-level contract verifier.

::

    python -m mpi_tpu_torch.analysis.ir                    # full matrix, card
    python -m mpi_tpu_torch.analysis.ir --device cpu --fast  # fast tier, CPU
    python -m mpi_tpu_torch.analysis.ir --cell seam_1x1    # one cell
    python -m mpi_tpu_torch.analysis.ir --device cpu --write-baseline
    python -m mpi_tpu_torch.analysis.ir --format json      # machine-readable
    python -m mpi_tpu_torch.analysis.ir --list-cells

Exit codes match ``python -m mpi_tpu_torch.analysis``: 0 clean, 1 any
finding, 2 internal error (a cell failed to run, an unknown cell, or
``--device cuda`` without a card) — a broken verifier must never read as
a passing one.  The device is the card unless ``--device cpu`` asks for
the kernels' plain versions; there is no quiet fallback.
"""

from __future__ import annotations

import argparse
import json
import sys

from mpi_tpu_torch.analysis.ir import run_ir, write_baseline


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi_tpu_torch.analysis.ir",
        description="launch-level contract verifier (donation, host "
                    "reads, plan_signature soundness, launch drift)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the cells' engines run (default: the "
                             "card; cpu runs the kernels' plain versions)")
    parser.add_argument("--fast", action="store_true",
                        help="run only the fast tier of the matrix")
    parser.add_argument("--cell", action="append", default=None,
                        metavar="ID", help="run only this matrix cell "
                                           "(repeatable; see --list-cells)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="bless the current canonical fingerprints as "
                             "analysis/ir/baseline.json")
    parser.add_argument("--no-baseline", action="store_true",
                        help="skip the drift check")
    parser.add_argument("--format", choices=("human", "json"),
                        default="human",
                        help="diagnostic format (default: human)")
    parser.add_argument("--list-cells", action="store_true")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="findings only, no summary line")
    args = parser.parse_args(argv)

    if args.list_cells:
        from mpi_tpu_torch.analysis.ir.matrix import CELLS

        for c in CELLS:
            batched = f" B={c.batch}" if c.batch else ""
            print(f"{c.id:24s} [{c.tier:4s}] {c.rows}x{c.cols} "
                  f"rule={c.rule} boundary={c.boundary} K={c.comm_every} "
                  f"sparse={c.sparse_tile} depth={c.depth}{batched}")
        return 0

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: CUDA is not available (no card); run on the "
              "card, or ask for the CPU with --device cpu", file=sys.stderr)
        return 2
    try:
        report = run_ir(
            device=args.device, fast_only=args.fast, cell_ids=args.cell,
            # a baseline run judges the *other* checks first; drift
            # against the stale baseline would be pure noise
            use_baseline=not (args.no_baseline or args.write_baseline))
    except KeyError as e:   # unknown --cell id
        print(str(e.args[0]) if e.args else str(e), file=sys.stderr)
        return 2

    if args.write_baseline:
        if report.errors:
            for e in report.errors:
                print(f"error: {e}", file=sys.stderr)
            print("refusing to write a baseline from a partial run",
                  file=sys.stderr)
            return 2
        out = write_baseline(report.recorded)
        print(f"wrote {len(report.recorded)} cell fingerprint(s) to {out}")
        return 0

    if args.format == "json":
        json.dump(report.to_json(), sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        for f in report.findings:
            print(f.format())
        for e in report.errors:
            print(f"error: {e}", file=sys.stderr)
        if not args.quiet:
            print(f"{len(report.findings)} finding(s) over "
                  f"{len(report.recorded)} recorded cell(s) on "
                  f"{report.device}", file=sys.stderr)
    if report.errors:
        return 2
    return 1 if report.findings else 0


if __name__ == "__main__":
    sys.exit(main())
