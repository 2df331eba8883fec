"""CLI: ``python -m repro_torch.analysis src/repro_torch [options]``.

Exit status is the CI contract: 0 = no unbaselined findings (and, with
``--runtime-gate``, the steady-state contract held), 1 = new findings
or a gate violation, 2 = usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.engine import Analyzer
from repro_torch.analysis.report import (
    diff_baseline,
    human_report,
    json_report,
    load_baseline,
    write_baseline,
)
from repro_torch.analysis.rules import ALL_RULES
from repro_torch.analysis.runtime import run_service_gate

DEFAULT_BASELINE = Path(__file__).with_name("baseline.json")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="PyTorch-discipline static analysis + runtime sync gate",
    )
    ap.add_argument("paths", nargs="*", help="files/directories to analyze")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="baseline file (default: the committed one)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, baseline ignored")
    ap.add_argument("--write-baseline", action="store_true",
                    help="commit current findings as the new baseline")
    ap.add_argument("--runtime-gate", action="store_true",
                    help="run the SolveService smoke build/sync gate")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the runtime gate (default: the card)")
    args = ap.parse_args(argv)

    if not args.paths and not args.runtime_gate:
        ap.print_usage(sys.stderr)
        return 2

    status = 0
    if args.paths:
        analyzer = Analyzer(ALL_RULES)
        findings = analyzer.run(args.paths)
        baseline = (
            [] if args.no_baseline else load_baseline(args.baseline)
        )
        if args.write_baseline:
            write_baseline(findings, args.baseline, previous=baseline)
            print(f"baseline written: {args.baseline} "
                  f"({len(findings)} finding(s))")
            return 0
        new, stale = diff_baseline(findings, baseline)
        if args.json:
            print(json_report(new))
        else:
            print(human_report(new))
            if stale:
                print(f"note: {len(stale)} stale baseline entr(y/ies) — "
                      "the violation was fixed; run --write-baseline")
            if baseline and len(findings) != len(new):
                print(f"({len(findings) - len(new)} baselined finding(s) "
                      "suppressed)")
        if new:
            status = 1

    if args.runtime_gate:
        report = run_service_gate(device=args.device)
        print(json.dumps(report, indent=2, sort_keys=True))
        if not report["ok"]:
            print("runtime gate FAILED: steady-state contract violated",
                  file=sys.stderr)
            status = 1
        else:
            print("runtime gate ok: 0 post-warmup builds, "
                  "0 dispatch-phase host syncs")

    return status


if __name__ == "__main__":
    sys.exit(main())
