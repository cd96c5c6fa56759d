"""repro-lint CLI of the port: ``python -m repro_torch.launch.lint
[--root DIR] [...]``.

Counterpart of ``repro/launch/lint.py``, with the same flags, output and
exit codes, over the port's analyzer (``repro_torch.analysis``), which
also checks the port's own wire planes.  Pure stdlib: it runs in a bare
CI container and on a machine with neither JAX nor numpy (it imports no
torch either).

Exit codes: 0 clean, 1 findings, 2 usage/IO error.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-lint",
        description="static analysis for wire-protocol, lock-discipline, "
                    "JAX-hygiene, and telemetry invariants")
    ap.add_argument("--root", default=".",
                    help="tree to analyze (default: cwd)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule families to run "
                         "(WP,LD,JX,TM,TL); default all")
    ap.add_argument("--include-fixtures", action="store_true",
                    help="also scan directories named 'fixtures' "
                         "(deliberately broken test inputs)")
    args = ap.parse_args(argv)

    root = pathlib.Path(args.root)
    if not root.is_dir():
        print(f"repro-lint: not a directory: {root}", file=sys.stderr)
        return 2

    from repro_torch.analysis import run_analysis
    select = args.select.split(",") if args.select else None
    result = run_analysis(root, select=select,
                          exclude_fixtures=not args.include_fixtures)

    if args.format == "json":
        print(json.dumps(
            {"findings": [f.to_json() for f in result.findings],
             "stats": result.stats}, indent=2, sort_keys=True))
    else:
        for f in result.findings:
            print(f.render())
        n = len(result.findings)
        print(f"repro-lint: {n} finding{'s' if n != 1 else ''} in "
              f"{result.stats['files_scanned']} files")
    return 0 if result.clean else 1


if __name__ == "__main__":
    sys.exit(main())
