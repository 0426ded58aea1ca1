"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload W --seed N --seconds S --trace 0|1

from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit); the same numbers are the last lines of
standard error.  Without a CUDA card, with fewer cards than the cell
asks for, or with JAX or the JAX package loaded once the window has
closed, it prints no result and exits non-zero.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# top-level modules that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "mpi_tpu")


def loaded_forbidden(modules=None) -> list:
    """The modules of :data:`FORBIDDEN` that ``modules`` (default
    ``sys.modules``) holds, compared by whole top-level name."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def report(result: dict) -> None:
    """The numbers compared on standard error, then the result line."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench import harness

    marks = {"import_torch": time.perf_counter() - _T0}
    cell = harness.cell_entry(harness.load_manifest(), args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    marks["cuda_found"] = time.perf_counter() - _T0
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t0=_T0, marks=marks)
    found = loaded_forbidden()
    if found:
        print(f"portbench: loaded {found}: the program under test must not "
              f"load JAX or the JAX package", file=sys.stderr)
        return 3
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
