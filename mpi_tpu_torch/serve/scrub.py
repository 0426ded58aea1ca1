"""Offline state-dir verifier/repairer — the disaster-recovery entry
point of the durable state plane.

Walks every session record (head + last-good ancestors) and journal
under a ``--state-dir``, verifies each CRC frame, and reports what it
found.  With ``--repair`` it makes the directory adoptable again:
corrupt records are quarantined to ``<sid>.corrupt-<n>`` (renamed,
never deleted), torn journal tails are truncated back to the last
durable entry, and stale ``.tmp`` files from interrupted writes are
swept.  Repair never touches verifiable payload bytes, so running it is
always safe; the server's own restore path applies the same rules
online.  The flags, report and exit codes are the reference's
``tools/scrub.py``'s.

Usage:

    python -m mpi_tpu_torch.serve.scrub /var/lib/mpi_tpu           # verify
    python -m mpi_tpu_torch.serve.scrub /var/lib/mpi_tpu --repair  # fix
    python -m mpi_tpu_torch.serve.scrub /var/lib/mpi_tpu --json    # JSON

Exit codes: 0 = clean (or fully repaired), 1 = findings (remaining
issues after any repairs), 2 = internal error.
"""

from __future__ import annotations

import argparse
import json
import sys

from mpi_tpu_torch.serve.recovery import scan_state_dir


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mpi_tpu_torch.serve.scrub",
        description="verify/repair an mpi_tpu_torch serve --state-dir")
    ap.add_argument("state_dir", help="state directory to scrub")
    ap.add_argument("--repair", action="store_true",
                    help="quarantine corrupt records, truncate torn "
                         "journal tails, sweep stale .tmp files")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the report as one JSON object")
    args = ap.parse_args(argv)

    report = scan_state_dir(args.state_dir, repair=args.repair)

    if args.as_json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(f"scrub {report['state_dir']}: "
              f"{report['records_ok']} record(s) ok, "
              f"{report['records_corrupt']} corrupt, "
              f"{report['journals_ok']} journal(s) ok "
              f"({report['journal_entries']} entries), "
              f"{report['torn_tails']} torn tail(s), "
              f"{report['stale_tmp']} stale tmp")
        for issue in report["issues"]:
            print(f"  issue: {issue}")
        for fix in report["repaired"]:
            print(f"  repaired: {fix}")

    if report["clean"]:
        return 0
    if args.repair:
        # everything found was also fixed -> the dir is adoptable now
        fixed = len(report["repaired"])
        if fixed and fixed >= len(report["issues"]):
            if not args.as_json:
                print("scrub: all findings repaired; dir is adoptable")
            return 0
    return 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001 - CLI boundary
        print(f"scrub: internal error: {e}", file=sys.stderr)
        sys.exit(2)
