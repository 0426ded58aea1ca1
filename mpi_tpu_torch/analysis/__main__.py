"""CLI for the port's invariant checker suite.

::

    python -m mpi_tpu_torch.analysis                   # full suite, the port
    python -m mpi_tpu_torch.analysis --rule lock-discipline mpi_tpu_torch/serve
    python -m mpi_tpu_torch.analysis --changed-only    # git-dirty files only
    python -m mpi_tpu_torch.analysis --format json     # machine-readable
    python -m mpi_tpu_torch.analysis --write-baseline  # accept current findings
    python -m mpi_tpu_torch.analysis --list-rules

Exit codes: 0 clean (suppressed/baselined findings don't fail), 1 any
actionable finding, 2 internal error (a rule crashed or a scanned file
does not parse) — a broken checker must never read as a passing one.

Path-subset runs (explicit paths or ``--changed-only``) skip
project-wide rules (cross-file registry drift needs the whole tree to
judge — on a subset it would report every metric the subset doesn't
mention); name one explicitly via ``--rule`` to force it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from mpi_tpu_torch.analysis import (
    DEFAULT_SCOPE, all_rules, default_files, repo_root, run, write_baseline,
)


def _changed_paths(root):
    """Repo-relative git-dirty .py files under the lint scope, made
    absolute.  Covers modified, staged, and untracked files, those of a
    new untracked package included (a brand-new module must not dodge
    the lint); deletions drop out naturally because the file no longer
    exists."""
    out = subprocess.run(
        ["git", "status", "--porcelain", "--untracked-files=all"], cwd=root,
        capture_output=True, text=True, check=True)
    scope_dirs = tuple(e + "/" for e in DEFAULT_SCOPE)
    paths = []
    for line in out.stdout.splitlines():
        rel = line[3:].strip()
        if " -> " in rel:           # rename: lint the new name
            rel = rel.split(" -> ", 1)[1]
        rel = rel.strip('"')
        if not rel.endswith(".py"):
            continue
        if not (rel in DEFAULT_SCOPE or rel.startswith(scope_dirs)):
            continue
        p = os.path.join(root, rel)
        if os.path.isfile(p):
            paths.append(p)
    return sorted(paths)


def _report_json(report, n_files: int) -> dict:
    def enc(f):
        return {"rule": f.rule, "path": f.rel, "line": f.line,
                "col": f.col, "scope": f.scope, "message": f.message,
                "fingerprint": f.fingerprint()}

    return {
        "tool": "mpi_tpu_torch.analysis",
        "findings": [enc(f) for f in report.findings],
        "errors": list(report.errors),
        "summary": {
            "files": n_files,
            "findings": len(report.findings),
            "suppressed": len(report.suppressed),
            "baselined": len(report.baselined),
            "errors": len(report.errors),
        },
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi_tpu_torch.analysis",
        description="AST-based invariant checkers over mpi_tpu_torch "
                    "(donation safety, lock discipline, cached-codegen "
                    "purity, ctxvar hops, obs drift)")
    parser.add_argument("paths", nargs="*",
                        help="files or directories to scan (default: the "
                             "repo's mpi_tpu_torch/ and chip_smoke.py)")
    parser.add_argument("--rule", action="append", default=None,
                        metavar="NAME",
                        help="run only this rule (repeatable)")
    parser.add_argument("--changed-only", action="store_true",
                        help="scan only git-dirty files under the lint "
                             "scope (incremental pre-commit runs)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="record current findings as the baseline "
                             "(then edit in the mandatory reasons)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report baselined findings too")
    parser.add_argument("--format", choices=("human", "json"),
                        default="human",
                        help="diagnostic format (default: human)")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="findings only, no summary line")
    args = parser.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.name:18s} {r.doc}")
        return 0
    forced = set(args.rule or ())
    if args.rule:
        known = {r.name: r for r in rules}
        unknown = [n for n in args.rule if n not in known]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)} "
                  f"(see --list-rules)", file=sys.stderr)
            return 2
        rules = [known[n] for n in args.rule]

    root = repo_root()
    paths = None
    if args.changed_only:
        if args.paths:
            print("--changed-only and explicit paths are mutually "
                  "exclusive", file=sys.stderr)
            return 2
        try:
            paths = _changed_paths(root)
        except (subprocess.CalledProcessError, OSError) as e:
            print(f"--changed-only needs a git checkout: {e}",
                  file=sys.stderr)
            return 2
        if not paths:
            if not args.quiet and args.format == "human":
                print("no changed files under the lint scope",
                      file=sys.stderr)
            if args.format == "json":
                from mpi_tpu_torch.analysis import Report
                json.dump(_report_json(Report(), 0), sys.stdout, indent=2)
                sys.stdout.write("\n")
            return 0
    elif args.paths:
        paths = []
        for p in args.paths:
            p = os.path.abspath(p)
            if os.path.isdir(p):
                for dirpath, dirnames, filenames in os.walk(p):
                    dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                    paths.extend(os.path.join(dirpath, f)
                                 for f in sorted(filenames)
                                 if f.endswith(".py"))
            else:
                paths.append(p)

    if paths is not None:
        # a project-wide rule judged against a file subset reports the
        # rest of the tree as missing; keep it only if explicitly forced
        dropped = [r.name for r in rules
                   if r.file_check is None and r.name not in forced]
        if dropped:
            rules = [r for r in rules if r.file_check is not None
                     or r.name in forced]
            if not args.quiet and args.format == "human":
                print(f"note: skipping project-wide rule(s) on a path "
                      f"subset: {', '.join(dropped)} (run without paths, "
                      f"or force with --rule)", file=sys.stderr)

    report = run(root=root, rules=rules, paths=paths,
                 use_baseline=not args.no_baseline)

    if args.write_baseline:
        out = write_baseline(report.findings)
        print(f"wrote {len(report.findings)} fingerprint(s) to {out}; "
              f"fill in the 'reason' fields before committing")
        return 0

    n_files = len(paths if paths is not None else default_files(root))
    if args.format == "json":
        json.dump(_report_json(report, n_files), sys.stdout, indent=2,
                  sort_keys=True)
        sys.stdout.write("\n")
    else:
        for f in report.findings:
            print(f.format())
        for e in report.errors:
            print(f"error: {e}", file=sys.stderr)
        if not args.quiet:
            print(f"{len(report.findings)} finding(s) over {n_files} "
                  f"file(s) ({len(report.suppressed)} suppressed, "
                  f"{len(report.baselined)} baselined)",
                  file=sys.stderr)
    if report.errors:
        return 2
    return 1 if report.findings else 0


if __name__ == "__main__":
    sys.exit(main())
