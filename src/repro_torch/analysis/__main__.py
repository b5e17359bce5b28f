"""``python -m repro_torch.analysis`` — run the port's static contract
checkers.

Default: all three checkers (the collective inventory, the kernels'
launch geometry, the port's lint) on the tree; the JSON report goes to
``--json PATH`` (else stdout) and a summary to stderr; exit 1 on a
violation.  ``--fixture NAME`` runs a planted-violation fixture instead
and also exits 1 when the planted violation is (rightly) reported, which
proves the check fires.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis import Report

CHECKERS = ("collective", "launch", "lint")


def _run_checker(name: str):
    if name == "collective":
        from repro_torch.analysis import collective_check
        return collective_check.run()
    if name == "launch":
        from repro_torch.analysis import launch_check
        return launch_check.run()
    from repro_torch.analysis import lint
    return lint.run()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--only", choices=CHECKERS, action="append",
                        help="run a subset of checkers (repeatable)")
    parser.add_argument("--json", metavar="PATH",
                        help="write the JSON report here (default: stdout)")
    parser.add_argument("--fixture", metavar="NAME",
                        help="run a planted-violation fixture instead of "
                             "the tree; exits 1 when the check fires")
    parser.add_argument("--list-fixtures", action="store_true",
                        help="list fixture names and exit")
    args = parser.parse_args(argv)

    report = Report()
    if args.list_fixtures:
        from repro_torch.analysis import fixtures
        print("\n".join(sorted(fixtures.FIXTURES)))
        return 0
    if args.fixture:
        from repro_torch.analysis import fixtures
        report.extend("fixture", fixtures.run_fixture(args.fixture),
                      [args.fixture])
    else:
        for name in args.only or CHECKERS:
            violations, covered = _run_checker(name)
            report.extend(name, violations, covered)

    payload = json.dumps(report.to_dict(), indent=2)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(payload + "\n")
    else:
        print(payload)

    checked = sum(len(v) for v in report.checked.values())
    if report.ok:
        print(f"analysis OK: {checked} targets checked, no violations",
              file=sys.stderr)
        return 0
    print(f"analysis FAILED: {len(report.violations)} violation(s) across "
          f"{checked} checked targets", file=sys.stderr)
    for v in report.violations:
        print(f"  [{v.checker}/{v.rule}] {v.where}: {v.message}",
              file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
