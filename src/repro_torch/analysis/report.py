"""Finding reporters and committed-baseline diffing.

Counterpart of :mod:`repro.analysis.report`, carried over as it is; the
port's baseline is ``src/repro_torch/analysis/baseline.json``.

The baseline file makes the analyzer adoptable on a codebase with
deliberate rule exceptions: committed findings (each with a ``why``
justification) are subtracted from a run's results, so CI fails only
on *new* findings.  Identity is ``(rule, path, message)`` with counts
— line numbers drift with unrelated edits and are deliberately not
part of the key.

Workflow::

    python -m repro_torch.analysis src/repro_torch                   # diff vs baseline
    python -m repro_torch.analysis src/repro_torch --write-baseline  # re-commit it

``--write-baseline`` preserves existing ``why`` entries and stamps new
ones with ``TODO: justify`` — a baseline entry without a real
justification is itself a review finding.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Any, Iterable

from repro_torch.analysis.engine import Finding

BASELINE_VERSION = 1


def human_report(findings: Iterable[Finding]) -> str:
    findings = list(findings)
    lines = [
        f"{f.path}:{f.line}:{f.col + 1}  [{f.severity}] {f.rule}: {f.message}"
        for f in findings
    ]
    by_sev = Counter(f.severity for f in findings)
    total = sum(by_sev.values())
    summary = (
        "clean: no findings" if not total else
        f"{total} finding(s): " + ", ".join(
            f"{n} {sev}" for sev, n in sorted(by_sev.items())
        )
    )
    return "\n".join(lines + [summary])


def json_report(findings: Iterable[Finding]) -> str:
    findings = list(findings)
    return json.dumps(
        {
            "findings": [f.to_dict() for f in findings],
            "counts": dict(Counter(f.rule for f in findings)),
            "total": len(findings),
        },
        indent=2, sort_keys=True,
    )


# ------------------------------------------------------------------ baseline


def load_baseline(path: str | Path) -> list[dict[str, Any]]:
    path = Path(path)
    if not path.exists():
        return []
    data = json.loads(path.read_text())
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path} has version {data.get('version')!r}; "
            f"expected {BASELINE_VERSION}"
        )
    return data["entries"]


def diff_baseline(
    findings: Iterable[Finding], entries: Iterable[dict[str, Any]]
) -> tuple[list[Finding], list[dict[str, Any]]]:
    """(new findings, stale baseline entries).

    Each baseline entry absorbs up to ``count`` findings with the same
    ``(rule, path, message)``; overflow findings are new.  Entries that
    matched nothing are stale — the violation was fixed, and the entry
    should be dropped at the next ``--write-baseline``.
    """
    budget: Counter = Counter()
    for e in entries:
        budget[(e["rule"], e["path"], e["message"])] += int(e.get("count", 1))
    new: list[Finding] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        if budget[f.key] > 0:
            budget[f.key] -= 1
        else:
            new.append(f)
    stale = [
        {"rule": rule, "path": path, "message": message, "count": n}
        for (rule, path, message), n in sorted(budget.items())
        if n > 0
    ]
    return new, stale


def write_baseline(
    findings: Iterable[Finding],
    path: str | Path,
    *,
    previous: Iterable[dict[str, Any]] = (),
) -> None:
    """Commit the current findings as the new baseline.

    ``why`` justifications carry over from ``previous`` by key; new
    entries get a TODO so an unjustified baseline is visible in review.
    """
    whys = {
        (e["rule"], e["path"], e["message"]): e.get("why", "")
        for e in previous
    }
    counts: Counter = Counter(f.key for f in findings)
    entries = [
        {
            "rule": rule,
            "path": p,
            "message": message,
            "count": n,
            "why": whys.get((rule, p, message)) or "TODO: justify",
        }
        for (rule, p, message), n in sorted(counts.items())
    ]
    Path(path).write_text(json.dumps(
        {"version": BASELINE_VERSION, "entries": entries}, indent=2,
    ) + "\n")
