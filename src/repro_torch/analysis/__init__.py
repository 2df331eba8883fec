"""PyTorch-discipline static analysis and the runtime sync gate.

Counterpart of :mod:`repro.analysis` for the port.  It imports
``torch``, ``numpy`` and the standard library, never JAX and nothing of
the reference package.

Commands (exit status 0 = clean, 1 = new findings or a gate violation,
2 = usage error)::

    python -m repro_torch.analysis src/repro_torch           # AST rules vs the baseline
    python -m repro_torch.analysis --runtime-gate --device cpu   # live drain gate
    python -m repro_torch.analysis --runtime-gate            # the same on the card

Rule catalog (:mod:`repro_torch.analysis.rules`; scopes are path
substrings of the analyzed file):

* ``host-sync-in-hot-path`` (``serving/``) — ``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()``, ``.to("cpu")``, ``np.asarray`` /
  ``np.array``, ``float()`` / ``int()`` / ``bool()`` of a computed value
  or a ``synchronize()`` inside a loop of ``drain``, ``_next_stream``,
  ``_dispatch_micro_batch``, ``_admit``, ``step`` or ``run``.
* ``recompile-hazard`` (``core/engine.py``, ``kernels/``, ``serving/``)
  — ``torch.compile``, ``torch.jit.*`` or a CUDA graph capture built
  inside a function body.
* ``dtype-contract`` (``core/``, ``serving/``, ``kernels/``) — bf16
  outside ``kernels/`` and the ``sweep_dtype`` boundary functions; any
  narrowing in ``core/{solver,operating_point,refine,transform}.py``.
* ``unlocked-shared-state`` (``serving/``, ``distributed/``) —
  ``AdmissionQueue``, ``StreamBreaker``, ``FaultInjector`` mutated
  outside ``with self._lock:``.
* ``blocking-call-in-stream-loop`` (``serving/``, ``distributed/``) — an
  import, ``open``, ``subprocess.*`` or ``*.sleep`` in stream-loop code.
* ``swallowed-error`` (everywhere) — a bare ``except:``, or a broad
  handler whose body only passes.

The reference's ``donation-after-use`` is not ported: the port donates
no buffer.

Workflow: fix a finding, or suppress it on its line (or from a
comment-only line just above) with ``# repro: ignore[rule-name]`` and
the reason beside it; the syntax is the reference's, so one comment
serves both analyzers.  A legacy finding can instead go into the
committed baseline, ``src/repro_torch/analysis/baseline.json`` (empty
today), with ``--write-baseline``, which keys entries on (rule, path,
message) with counts, keeps each entry's ``why`` and stamps new ones
``TODO: justify``; entries that match nothing are reported stale.

The runtime gate (:mod:`repro_torch.analysis.runtime`) labels the
service's phases with :func:`sync_scope` (``dispatch``, ``harvest``,
``finish``, ``unpack``, ``settle_poll``, ``net_build``) and counts host
copies by label (:class:`SyncWatch`) and run-time builds
(:class:`BuildWatch`): after a warmup drain, the same drain must make
no build, no ``dispatch`` sync and some harvest-side syncs.
"""

from repro_torch.analysis.engine import (
    Analyzer,
    FileContext,
    Finding,
    Rule,
    is_suppressed,
    parse_suppressions,
)
from repro_torch.analysis.report import (
    diff_baseline,
    human_report,
    json_report,
    load_baseline,
    write_baseline,
)
from repro_torch.analysis.rules import ALL_RULES
from repro_torch.analysis.runtime import (
    BuildWatch,
    SyncWatch,
    run_service_gate,
    sync_scope,
)

__all__ = [
    "ALL_RULES",
    "Analyzer",
    "BuildWatch",
    "FileContext",
    "Finding",
    "Rule",
    "SyncWatch",
    "diff_baseline",
    "human_report",
    "is_suppressed",
    "json_report",
    "load_baseline",
    "parse_suppressions",
    "run_service_gate",
    "sync_scope",
    "write_baseline",
]
