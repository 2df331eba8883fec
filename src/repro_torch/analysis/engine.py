"""AST rule engine for the port's PyTorch-discipline checks.

Counterpart of :mod:`repro.analysis.engine`, carried over as it is: the
framework is pure AST work and knows nothing of JAX or PyTorch.  The
serving stack's contracts (no host sync inside the dispatch loop, no
graph capture or compilation on the hot path, float64 accumulation
boundaries, no swallowed delivery errors) are invariants of *source
structure*, so they are checked as AST rules (see
:mod:`repro_torch.analysis.rules`) rather than in review.

Framework pieces:

* :class:`Rule` — one named check with a default severity and an
  options dict; subclasses implement ``check(ctx)`` yielding
  :class:`Finding` objects.
* :class:`FileContext` — a parsed file: repo-relative path, source,
  AST, and the per-line suppression table.
* **suppressions** — ``# repro: ignore[rule-a, rule-b]`` on a line (or
  on a comment-only line directly above it) suppresses those rules'
  findings there; a bare ``# repro: ignore`` suppresses every rule.
  The syntax is the reference's, so one comment serves both analyzers.
* :class:`Analyzer` — applies enabled rules to a file set, drops
  suppressed findings, returns them sorted.  Per-rule enable/severity/
  option overrides come in through ``config``.

Baseline diffing (so legacy findings never block CI while new ones do)
lives in :mod:`repro_torch.analysis.report`.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Any, Iterable, Iterator

SEVERITIES = ("error", "warning", "info")

# `# repro: ignore` or `# repro: ignore[rule-a, rule-b]`
_SUPPRESS_RE = re.compile(
    r"#\s*repro:\s*ignore(?:\[([^\]]*)\])?"
)

# sentinel rule-name set meaning "every rule suppressed on this line"
_ALL_RULES = frozenset({"*"})


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str                   # repo-relative, posix separators
    line: int                   # 1-indexed
    col: int                    # 0-indexed (ast convention)
    severity: str
    message: str

    @property
    def key(self) -> tuple[str, str, str]:
        """Baseline identity: line numbers drift with unrelated edits,
        so baselines match on (rule, path, message) with counts."""
        return (self.rule, self.path, self.message)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def parse_suppressions(source: str) -> dict[int, frozenset[str]]:
    """Per-line suppressed-rule sets from ``# repro: ignore`` comments.

    A comment on a code line covers that line; a comment-only line
    covers the *next* line too (the multiline-call-friendly form).
    """
    out: dict[int, frozenset[str]] = {}
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        names = m.group(1)
        if names is None:
            rules = _ALL_RULES
        else:
            rules = frozenset(
                n.strip() for n in names.split(",") if n.strip()
            )
            if not rules:
                rules = _ALL_RULES
        out[lineno] = out.get(lineno, frozenset()) | rules
        if text.lstrip().startswith("#"):
            out[lineno + 1] = out.get(lineno + 1, frozenset()) | rules
    return out


def is_suppressed(
    finding: Finding, suppressions: dict[int, frozenset[str]]
) -> bool:
    rules = suppressions.get(finding.line)
    if not rules:
        return False
    return "*" in rules or finding.rule in rules


@dataclasses.dataclass
class FileContext:
    """One parsed source file handed to every rule."""

    path: str                   # repo-relative, posix separators
    source: str
    tree: ast.Module
    suppressions: dict[int, frozenset[str]]

    @classmethod
    def parse(cls, file_path: Path, root: Path) -> "FileContext":
        source = file_path.read_text()
        try:
            rel = file_path.resolve().relative_to(root.resolve())
        except ValueError:
            rel = file_path
        return cls(
            path=rel.as_posix(),
            source=source,
            tree=ast.parse(source, filename=str(file_path)),
            suppressions=parse_suppressions(source),
        )

    def matches(self, patterns: Iterable[str]) -> bool:
        """Whether this file is in a rule's scope: each pattern is a
        path substring (``"serving/"``) or filename (``"engine.py"``)."""
        return any(p in self.path for p in patterns)


class Rule:
    """Base class: one named check over one :class:`FileContext`."""

    name: str = ""
    severity: str = "error"
    description: str = ""
    default_options: dict[str, Any] = {}

    def __init__(self, *, severity: str | None = None,
                 options: dict[str, Any] | None = None):
        if severity is not None:
            if severity not in SEVERITIES:
                raise ValueError(f"unknown severity {severity!r}")
            self.severity = severity
        self.options = {**self.default_options, **(options or {})}

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: FileContext, node: ast.AST, message: str) -> Finding:
        return Finding(
            rule=self.name,
            path=ctx.path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            severity=self.severity,
            message=message,
        )


# --------------------------------------------------------------- AST helpers


def dotted_name(node: ast.AST) -> str | None:
    """``np.asarray`` -> "np.asarray"; None for non-name chains."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def walk_functions(
    tree: ast.Module,
) -> Iterator[tuple[ast.FunctionDef | ast.AsyncFunctionDef, list[ast.AST]]]:
    """Every function def with its enclosing scope stack (outermost
    first; the stack holds Module/ClassDef/FunctionDef nodes)."""
    def rec(node: ast.AST, stack: list[ast.AST]) -> Iterator:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child, stack
                yield from rec(child, stack + [child])
            elif isinstance(child, ast.ClassDef):
                yield from rec(child, stack + [child])
            else:
                yield from rec(child, stack)
    yield from rec(tree, [tree])


def loops_in(func: ast.AST) -> Iterator[ast.For | ast.While]:
    """Loops belonging to ``func`` itself (nested defs excluded)."""
    def rec(node: ast.AST) -> Iterator:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(child, (ast.For, ast.While)):
                yield child
            rec_iter = rec(child)
            yield from rec_iter
    yield from rec(func)


def calls_in(node: ast.AST, *, into_defs: bool = False) -> Iterator[ast.Call]:
    def rec(n: ast.AST) -> Iterator:
        for child in ast.iter_child_nodes(n):
            if not into_defs and isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            if isinstance(child, ast.Call):
                yield child
            yield from rec(child)
    yield from rec(node)


# ------------------------------------------------------------------ analyzer


class Analyzer:
    """Applies a rule set to a file tree.

    ``config`` maps rule name to overrides::

        {"host-sync-in-hot-path": {"enabled": True,
                                   "severity": "error",
                                   "hot_functions": [...]}}

    Unknown keys inside a rule's entry become rule options.
    """

    def __init__(self, rules: Iterable[type[Rule]],
                 config: dict[str, dict[str, Any]] | None = None):
        config = config or {}
        self.rules: list[Rule] = []
        for rule_cls in rules:
            entry = dict(config.get(rule_cls.name, {}))
            if not entry.pop("enabled", True):
                continue
            severity = entry.pop("severity", None)
            self.rules.append(rule_cls(severity=severity, options=entry))

    @staticmethod
    def collect_files(paths: Iterable[str | Path],
                      root: Path | None = None) -> list[Path]:
        files: list[Path] = []
        for p in paths:
            p = Path(p)
            if p.is_dir():
                files.extend(sorted(p.rglob("*.py")))
            else:
                files.append(p)
        return files

    def run(self, paths: Iterable[str | Path],
            root: Path | None = None) -> list[Finding]:
        root = Path(root) if root is not None else Path.cwd()
        findings: list[Finding] = []
        for file_path in self.collect_files(paths, root):
            try:
                ctx = FileContext.parse(file_path, root)
            except (SyntaxError, UnicodeDecodeError) as exc:
                findings.append(Finding(
                    rule="parse-error", path=str(file_path), line=1, col=0,
                    severity="error", message=f"unparseable: {exc}",
                ))
                continue
            for rule in self.rules:
                for f in rule.check(ctx):
                    if not is_suppressed(f, ctx.suppressions):
                        findings.append(f)
        findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
        return findings
