"""``python -m mpi_tpu_torch.tune``: the autotuner runner and the
tune-cache staleness gate.

Modes (exit codes: 0 clean, 1 findings, 2 internal error):

* default: tune one plan (``--rows/--cols/--rule/...``) on ``--device``
  (the card unless ``--device cpu``), persist the winner, print a JSON
  summary;
* ``--check``: validate every cached entry under the CURRENT config rules
  (key still resolves, base still constructs, plan still applies).  A
  missing cache file is clean: no entries, nothing stale;
* ``--list``: dump the cache entries.

``--mesh MIxMJ`` tunes on that mesh (default: ``choose_mesh_shape`` of
every card, or 1x1 on the CPU, whose meshes run on its virtual devices);
the key and the cache entry carry the shape, as the reference's do.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi_tpu_torch.tune",
        description="cost-card-guided plan autotuner "
        "(kernel pass depth, sparse tile, CTA tile, batch)")
    p.add_argument("--rows", type=int, default=1024)
    p.add_argument("--cols", type=int, default=1024)
    p.add_argument("--rule", default="life")
    p.add_argument("--boundary", default="periodic",
                   choices=("periodic", "dead"))
    p.add_argument("--mesh", default=None, metavar="MIxMJ",
                   help="device mesh (default: auto)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cpu probes the kernels' plain versions")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=64,
                   help="generations per timed probe")
    p.add_argument("--reps", type=int, default=2,
                   help="timed repetitions per candidate (best-of)")
    p.add_argument("--settle", type=int, default=0,
                   help="untimed generations before each timed window "
                   "(probes state-carrying engines in steady state)")
    p.add_argument("--batch", action="store_true",
                   help="also probe batched (B-board) dispatch as a "
                   "serving hint")
    p.add_argument("--min-speedup", type=float, default=1.05,
                   help="winners inside this noise band stay default")
    p.add_argument("--cache", default=None, metavar="PATH",
                   help="tune cache file (default "
                   "perf/tune_cache_torch.json; env MPI_TPU_TUNE_CACHE)")
    p.add_argument("--check", action="store_true",
                   help="validate every cached entry under current "
                   "config rules and exit (0 clean / 1 findings)")
    p.add_argument("--list", action="store_true", dest="list_entries",
                   help="print the cache entries and exit")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mpi_tpu_torch.tune import TuneCache

    cache = TuneCache(args.cache)
    if args.check:
        findings = cache.check()
        for f in findings:
            print(f"tune-check: {f}")
        print(f"tune-check: {len(cache)} entr"
              f"{'y' if len(cache) == 1 else 'ies'} in {cache.path}, "
              f"{len(findings)} finding(s)")
        return 1 if findings else 0
    if args.list_entries:
        print(json.dumps(cache.entries(), indent=1, sort_keys=True))
        return 0
    from mpi_tpu_torch.config import ConfigError, GolConfig
    from mpi_tpu_torch.models.rules import rule_from_name
    from mpi_tpu_torch.tune import tune_plan

    if args.mesh:
        try:
            mi, mj = args.mesh.lower().split("x")
            mesh = (int(mi), int(mj))
        except ValueError:
            print(f"bad --mesh {args.mesh!r} (want MIxMJ)", file=sys.stderr)
            return 2
    else:
        mesh = None
    try:
        config = GolConfig(
            rows=args.rows, cols=args.cols, steps=0, seed=args.seed,
            rule=rule_from_name(args.rule), boundary=args.boundary,
            backend="cuda", mesh_shape=mesh)
        res = tune_plan(config, device=args.device, steps=args.steps,
                        reps=args.reps, settle=args.settle,
                        cache=cache, include_batch=args.batch,
                        min_speedup=args.min_speedup,
                        verbose=not args.quiet)
    except ConfigError as e:
        print(f"config error: {e}", file=sys.stderr)
        return 2
    except Exception as e:  # noqa: BLE001 — runner exit-code contract
        print(f"tune failed: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    print(json.dumps(res.as_dict(), sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
