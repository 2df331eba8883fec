"""repro_torch.analysis against repro.analysis, and its runtime gate.

The rules the port carries over unchanged (swallowed-error,
blocking-call-in-stream-loop, unlocked-shared-state), the suppressions,
parse errors, config overrides, the baseline diff and both reporters are
held against the reference package on the same fixtures: the findings,
and the reporters' output byte for byte, must be equal.  The retargeted
rules (host-sync-in-hot-path, recompile-hazard, dtype-contract) get
PyTorch fixtures: a true positive, a true negative and a suppressed case
each.  The runtime watches are proven live on the CPU (``SyncWatch(
device_type="cpu")`` counts CPU tensors), and the service gate runs on
the CPU, once clean and once with a planted dispatch-phase sync.
"""

import ast
import json
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.analysis as ref
import repro.analysis.__main__ as ref_cli
import repro_torch.analysis as tan
import repro_torch.analysis.__main__ as tan_cli
from repro_torch.analysis import runtime as trt
from repro_torch.analysis.runtime import BuildWatch, SyncWatch, sync_scope

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def run_on(pkg, tmp_path, rel_path, source, rules=None, config=None):
    """Analyze one fixture snippet at a repo-relative-like path."""
    f = tmp_path / rel_path
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(source))
    return pkg.Analyzer(rules or pkg.ALL_RULES, config).run([f], root=tmp_path)


def rows(findings):
    return [(f.rule, f.path, f.line, f.col, f.message) for f in findings]


def both(tmp_path, rel_path, source, config=None):
    """The same fixture through both analyzers: (reference rows, port rows)."""
    return (rows(run_on(ref, tmp_path, rel_path, source, config=config)),
            rows(run_on(tan, tmp_path, rel_path, source, config=config)))


# ------------------------------------------- rules carried over unchanged

SWALLOWED = """
    def deliver(t):
        try:
            t.send()
        except Exception:
            pass

    def harvest(t):
        try:
            t.wait()
        except:
            return None

    def probe(t):
        try:
            t.poll()
        except (ValueError, FaultInjected):
            pass
"""

HANDLED = """
    def deliver(t, out):
        try:
            t.send()
        except Exception as exc:
            out[t.rid] = make_error(exc)

    def narrow(t):
        try:
            t.wait()
        except TimeoutError:
            pass
"""

UNLOCKED = """
    class AdmissionQueue:
        def __init__(self):
            self._items = []

        def push(self, item):
            self._items.append(item)
            self.depth += 1
"""

LOCKED = """
    import threading

    class AdmissionQueue:
        def __init__(self):
            self._items = []
            self._lock = threading.Lock()

        def push(self, item):
            with self._lock:
                self._items.append(item)

        def __len__(self):
            return len(self._items)
"""

BLOCKING = """
    class S:
        def step(self):
            import time
            time.sleep(0.1)

        def _harvest(self, f):
            with open(f) as fh:
                return fh.read()

        def acquire(self, dev):
            import subprocess
            subprocess.run(["true"])
"""

BLOCKING_SUPPRESSED = """
    import time

    class S:
        def step(self):
            # injected-slow chaos fault: the stall is the point
            time.sleep(0.1)  # repro: ignore[blocking-call-in-stream-loop]
"""

SHARED_CASES = [
    ("serving/d.py", SWALLOWED, 3),
    ("core/d.py", SWALLOWED, 3),
    ("serving/d.py", HANDLED, 0),
    ("serving/q.py", UNLOCKED, 2),
    ("distributed/q.py", UNLOCKED.replace("AdmissionQueue", "StreamBreaker"), 2),
    ("serving/faults.py", UNLOCKED.replace("AdmissionQueue", "FaultInjector"), 2),
    ("serving/q.py", UNLOCKED.replace("AdmissionQueue", "LocalScratch"), 0),
    ("core/q.py", UNLOCKED, 0),
    ("serving/q.py", LOCKED, 0),
    ("serving/e.py", BLOCKING, 5),
    ("distributed/e.py", BLOCKING, 5),
    ("core/e.py", BLOCKING, 0),
    ("serving/e.py", BLOCKING.replace("def step", "def build_report"), 3),
    ("serving/e.py", BLOCKING_SUPPRESSED, 0),
]


@pytest.mark.parametrize("rel_path,source,count", SHARED_CASES)
def test_unchanged_rules_match_the_reference(tmp_path, rel_path, source, count):
    want, got = both(tmp_path, rel_path, source)
    assert got == want
    assert len(got) == count


# ---------------------------------------- suppressions, parse errors, config

SUPPRESSION_SOURCES = [
    "x = 1  # repro: ignore\n"
    "y = 2  # repro: ignore[rule-a, rule-b]\n"
    "# repro: ignore[rule-c]\n"
    "z = 3\n"
    "w = 4\n",
    "a = 1  #repro:ignore[]\n# repro: ignore\nb = 2\n",
    "def f():\n    pass  # repro: ignore[ x ,, y ]\n",
]


@pytest.mark.parametrize("source", SUPPRESSION_SOURCES)
def test_suppression_tables_match_the_reference(source):
    assert tan.parse_suppressions(source) == ref.parse_suppressions(source)


SUPPRESSED_FORMS = {
    "bare": """
        import time

        class S:
            def step(self):
                time.sleep(0.1)  # repro: ignore
    """,
    "list": """
        import time

        class S:
            def step(self):
                time.sleep(0.1)  # repro: ignore[swallowed-error, blocking-call-in-stream-loop]
    """,
    "comment_line": """
        import time

        class S:
            def step(self):
                # repro: ignore[blocking-call-in-stream-loop]
                time.sleep(
                    0.1)
    """,
    "other_rule": """
        import time

        class S:
            def step(self):
                time.sleep(0.1)  # repro: ignore[swallowed-error]
    """,
}


@pytest.mark.parametrize("form", sorted(SUPPRESSED_FORMS))
def test_suppression_forms_match_the_reference(tmp_path, form):
    want, got = both(tmp_path, "serving/e.py", SUPPRESSED_FORMS[form])
    assert got == want
    assert len(got) == (1 if form == "other_rule" else 0)


def test_parse_errors_match_the_reference(tmp_path):
    want, got = both(tmp_path, "serving/broken.py", "def f(:\n")
    assert got == want
    assert [r[0] for r in got] == ["parse-error"]


@pytest.mark.parametrize("config,count", [
    ({}, 3),
    ({"swallowed-error": {"enabled": False}}, 0),
    ({"swallowed-error": {"severity": "warning"}}, 3),
    ({"swallowed-error": {"modules": ("core/",)}}, 0),
    ({"swallowed-error": {"broad_types": ("ValueError",)}}, 2),
])
def test_config_overrides_match_the_reference(tmp_path, config, count):
    pkgs = []
    for pkg in (ref, tan):
        found = run_on(pkg, tmp_path, "serving/d.py", SWALLOWED, config=config)
        pkgs.append([(f.severity,) + r for f, r in zip(found, rows(found))])
    assert pkgs[1] == pkgs[0]
    assert len(pkgs[1]) == count


def test_unknown_severity_raises_in_both():
    for pkg in (ref, tan):
        with pytest.raises(ValueError):
            pkg.Analyzer(pkg.ALL_RULES, {"swallowed-error": {"severity": "loud"}})


# --------------------------------------------------- baseline and reporters


def findings_of(pkg):
    mk = lambda rule, path, line, message, sev="error": pkg.Finding(
        rule=rule, path=path, line=line, col=line % 3, severity=sev, message=message)
    return [mk("r", "p.py", 1, "m"), mk("r", "p.py", 9, "m"), mk("r", "p.py", 30, "m"),
            mk("s", "a/q.py", 4, "other", "warning"), mk("t", "b.py", 2, "x", "info")]


BASELINE_ENTRIES = [
    {"rule": "r", "path": "p.py", "message": "m", "count": 2, "why": "legacy"},
    {"rule": "gone", "path": "old.py", "message": "fixed", "count": 1, "why": "old"},
    {"rule": "t", "path": "b.py", "message": "x"},
]


def test_reporters_match_the_reference_byte_for_byte():
    want, got = findings_of(ref), findings_of(tan)
    assert tan.human_report(got) == ref.human_report(want)
    assert tan.json_report(got) == ref.json_report(want)
    assert tan.human_report([]) == ref.human_report([]) == "clean: no findings"
    assert tan.json_report([]) == ref.json_report([])


def test_baseline_diff_and_stale_entries_match_the_reference():
    new_ref, stale_ref = ref.diff_baseline(findings_of(ref), BASELINE_ENTRIES)
    new_tan, stale_tan = tan.diff_baseline(findings_of(tan), BASELINE_ENTRIES)
    assert rows(new_tan) == rows(new_ref)
    assert stale_tan == stale_ref
    assert len(new_tan) == 2              # the third "m" overflows, "s" is new
    assert stale_tan == [{"rule": "gone", "path": "old.py", "message": "fixed",
                          "count": 1}]


def test_write_baseline_keeps_why_and_matches_the_reference(tmp_path):
    out = {}
    for name, pkg in (("ref", ref), ("tan", tan)):
        path = tmp_path / f"{name}.json"
        pkg.write_baseline(findings_of(pkg), path, previous=BASELINE_ENTRIES)
        out[name] = path.read_bytes()
        entries = pkg.load_baseline(path)
        whys = {(e["rule"], e["path"]): e["why"] for e in entries}
        assert whys[("r", "p.py")] == "legacy"
        assert whys[("s", "a/q.py")] == "TODO: justify"
        assert [e["count"] for e in entries if e["rule"] == "r"] == [3]
    assert out["tan"] == out["ref"]


def test_baseline_version_mismatch_raises_in_both(tmp_path):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"version": 99, "entries": []}))
    for pkg in (ref, tan):
        with pytest.raises(ValueError):
            pkg.load_baseline(path)
    assert tan.load_baseline(tmp_path / "missing.json") == []


@pytest.mark.parametrize("cli", [ref_cli, tan_cli], ids=["reference", "port"])
def test_cli_exit_codes_and_write_baseline(tmp_path, cli, capsys):
    src = tmp_path / "serving" / "d.py"
    src.parent.mkdir(parents=True)
    src.write_text(textwrap.dedent(SWALLOWED))
    baseline = str(tmp_path / "baseline.json")
    assert cli.main([]) == 2
    assert cli.main([str(src), "--baseline", baseline]) == 1
    assert cli.main([str(src), "--baseline", baseline, "--write-baseline"]) == 0
    assert cli.main([str(src), "--baseline", baseline]) == 0
    capsys.readouterr()
    assert cli.main([str(src), "--baseline", baseline, "--no-baseline", "--json"]) == 1
    assert json.loads(capsys.readouterr().out)["total"] == 3


# --------------------------------------------------- host-sync-in-hot-path

HOT_LOOP_BAD = """
    import numpy as np
    import torch

    class S:
        def drain(self):
            for flight in self.inflight:
                a = flight.res.item()
                b = flight.res.cpu()
                c = flight.res.tolist()
                d = flight.res.numpy()
                e = flight.res.to("cpu")
                f = flight.res.to(device=torch.device("cpu"))
                g = np.asarray(flight.result)
                h = float(flight.elapsed)
                i = int(flight.n)
                torch.cuda.synchronize()
                flight.event.synchronize()
            while bool(self.active.any()):
                self.step_once()
"""

HOT_LOOP_OK = """
    import numpy as np
    import torch

    class S:
        def drain(self):
            x = self.res.item()                  # outside any loop
            for flight in self.inflight:
                self.pending.append(flight)
                y = flight.res.to("cuda")
                z = flight.res.to(torch.float64)
                w = float(1.0)

        def _unpack(self):
            # not a hot function: a host copy is fine here
            return [np.asarray(b.x) for b in self.batches]
"""

HOT_LOOP_SUPPRESSED = """
    class S:
        def drain(self):
            for f in self.inflight:
                # f.ready is a host bool the harvest set
                # repro: ignore[host-sync-in-hot-path]
                if bool(f.ready):
                    x = f.res.item()  # repro: ignore[host-sync-in-hot-path]
"""


def test_host_sync_flags_torch_syncs_in_hot_loops(tmp_path):
    found = run_on(tan, tmp_path, "serving/loop.py", HOT_LOOP_BAD)
    assert {f.rule for f in found} == {"host-sync-in-hot-path"}
    assert len(found) == 12
    assert sum("synchronize()" in f.message for f in found) == 2


@pytest.mark.parametrize("rel_path,source", [
    ("serving/loop.py", HOT_LOOP_OK),
    ("core/loop.py", HOT_LOOP_BAD),       # outside serving/: out of scope
    ("serving/loop.py", HOT_LOOP_SUPPRESSED),
])
def test_host_sync_negatives_and_suppression(tmp_path, rel_path, source):
    assert run_on(tan, tmp_path, rel_path, source) == []


# -------------------------------------------------------- recompile-hazard

COMPILE_IN_BODY = """
    import torch

    def sweep(m, z):
        f = torch.compile(lambda x: m @ x)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            z = f(z)
        g.capture_begin()
        s = torch.jit.script(sweep)
        h = torch.cuda.make_graphed_callables(f, (z,))
        return z
"""

COMPILE_ONCE = """
    import torch

    _step = torch.compile(lambda x: x * 2)

    @torch.compile
    def fused(x):
        return x + 1

    class Engine:
        def __init__(self):
            self.graph = torch.cuda.CUDAGraph()
            self._step = torch.compile(lambda c: c)

        def step(self, x):
            self.graph.replay()
            return self._step(x)
"""

COMPILE_SUPPRESSED = """
    import torch

    def warmup(f):
        # captured once per process by the caller's cache
        return torch.compile(f)  # repro: ignore[recompile-hazard]
"""


def test_recompile_flags_compiles_and_captures_in_a_body(tmp_path):
    found = run_on(tan, tmp_path, "kernels/k.py", COMPILE_IN_BODY)
    assert {f.rule for f in found} == {"recompile-hazard"}
    assert len(found) == 6


@pytest.mark.parametrize("rel_path,source", [
    ("kernels/k.py", COMPILE_ONCE),
    ("core/spectral.py", COMPILE_IN_BODY),     # outside the hot modules
    ("serving/k.py", COMPILE_SUPPRESSED),
])
def test_recompile_negatives_and_suppression(tmp_path, rel_path, source):
    assert run_on(tan, tmp_path, rel_path, source) == []


# ---------------------------------------------------------- dtype-contract

BF16_ESCAPE = """
    import torch

    def prepare(m):
        a = m.to(torch.bfloat16)
        b = m.bfloat16()
        c = torch.zeros(3, dtype=torch.bfloat16)
        return a, b, c
"""

BF16_IN_BOUNDARY = """
    import torch

    def euler_settle_batch(m):
        return m.to(torch.bfloat16), torch.ones(2, dtype=torch.bfloat16)
"""

X64_NARROWING = """
    import numpy as np
    import torch

    def refine(r):
        a = r.float()
        b = r.half()
        c = r.to(torch.float32)
        d = r.to(dtype=torch.float16)
        e = torch.zeros(3, dtype=torch.float)
        f = np.asarray(r).astype(np.float32)
        return a, b, c, d, e, f
"""

X64_WIDE = """
    import numpy as np
    import torch

    def refine(r):
        a = r.to(torch.float64)
        b = r.double()
        c = torch.zeros(3, dtype=torch.float64)
        d = np.zeros(3, dtype=float)
        return a, b, c, d
"""

DTYPE_SUPPRESSED = """
    import torch

    def refine(r):
        # the int8 pot model rounds through float32 on purpose
        return r.float()  # repro: ignore[dtype-contract]
"""


@pytest.mark.parametrize("rel_path,source,count", [
    ("serving/svc.py", BF16_ESCAPE, 3),
    ("core/refine.py", X64_NARROWING, 6),
    ("core/solver.py", BF16_ESCAPE, 3),
])
def test_dtype_flags_bf16_escape_and_x64_narrowing(tmp_path, rel_path, source, count):
    found = run_on(tan, tmp_path, rel_path, source)
    assert {f.rule for f in found} == {"dtype-contract"}
    assert len(found) == count


@pytest.mark.parametrize("rel_path,source", [
    ("kernels/sweep.py", BF16_ESCAPE),           # the kernels are the boundary
    ("core/engine.py", BF16_IN_BOUNDARY),        # so are the sweep functions
    ("serving/svc.py", X64_NARROWING),           # not a float64 module
    ("core/refine.py", X64_WIDE),
    ("core/refine.py", DTYPE_SUPPRESSED),
])
def test_dtype_negatives_and_suppression(tmp_path, rel_path, source):
    assert run_on(tan, tmp_path, rel_path, source) == []


def test_donation_rule_is_not_ported():
    names = {r.name for r in tan.ALL_RULES}
    assert names == {r.name for r in ref.ALL_RULES} - {"donation-after-use"}


# ------------------------------------------------------ the port's own tree


def test_port_tree_is_clean_against_its_baseline():
    findings = tan.Analyzer(tan.ALL_RULES).run([PORT], root=ROOT)
    entries = tan.load_baseline(tan_cli.DEFAULT_BASELINE)
    new, stale = tan.diff_baseline(findings, entries)
    assert new == [], tan.human_report(new)
    assert stale == []
    assert all(e.get("why") and not e["why"].startswith("TODO") for e in entries)


def test_port_files_import_neither_jax_nor_the_reference():
    bad = []
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {name}")
    assert bad == []


# ------------------------------------------------------------ runtime watches


def test_one_item_in_a_dispatch_scope_counts_one():
    t = torch.arange(3.0)
    with SyncWatch(device_type="cpu") as watch:
        with sync_scope("dispatch"):
            t[0].item()
    assert watch.counts == {"dispatch": 1}
    assert watch.calls == [("dispatch", "Tensor.item")]


def test_nested_scope_counts_to_the_inner_label():
    t = torch.arange(3.0)
    with SyncWatch(device_type="cpu") as watch:
        t.tolist()                               # ambient
        with sync_scope("dispatch"):
            with sync_scope("net_build"):
                t.cpu()
            t.numpy()
    assert watch.counts == {"ambient": 1, "net_build": 1, "dispatch": 1}
    assert watch.total() == 3 and watch.total("dispatch", "net_build") == 2
    assert trt._SCOPE_STACK == ["ambient"]


@pytest.mark.parametrize("entry,fn", [
    ("Tensor.item", lambda t: t[0].item()),
    ("Tensor.tolist", lambda t: t.tolist()),
    ("Tensor.numpy", lambda t: t.numpy()),
    ("Tensor.cpu", lambda t: t.cpu()),
    ("Tensor.__array__", lambda t: np.asarray(t)),
    ("Tensor.__float__", lambda t: float(t[0])),
    ("Tensor.__int__", lambda t: int(t[0])),
    ("Tensor.__bool__", lambda t: bool(t[0])),
    ("Tensor.to", lambda t: t.to("cpu")),
    ("Tensor.to", lambda t: t.to(device=torch.device("cpu"), dtype=torch.float64)),
    (None, lambda t: t.to(torch.float64)),       # a dtype cast copies nothing out
    (None, lambda t: float(np.float64(2.0))),    # a numpy operand
])
def test_each_host_copy_counts_exactly_once(entry, fn):
    t = torch.arange(3.0)
    with SyncWatch(device_type="cpu") as watch:
        with sync_scope("harvest"):
            fn(t)
    assert watch.calls == ([] if entry is None else [("harvest", entry)])


def test_sync_watch_counts_only_its_device_type_and_restores_patches():
    orig = torch.Tensor.item
    t = torch.arange(3.0)
    with SyncWatch() as watch:                   # cuda: CPU tensors are not counted
        t[0].item()
        t.cpu().numpy()
        with pytest.raises(RuntimeError):
            SyncWatch().__enter__()
    assert watch.counts == {}
    assert torch.Tensor.item is orig
    assert SyncWatch._active is None


def test_build_watch_counts_a_build_and_not_the_cached_return(tmp_path, monkeypatch):
    from repro_torch.kernels import build

    def fake_build(target):
        target.write_bytes(b"")
        return "built"

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "_build", fake_build)
    monkeypatch.setattr(build, "KernelLibrary", lambda path, seconds, log: (path, log))
    with BuildWatch() as first:
        lib = build.load_library()
    assert first.count == 1 and first.events[0][0] == "nvcc"
    assert lib[1] == "built"
    with BuildWatch() as cached:
        assert build.load_library() is lib      # the process's library
        monkeypatch.setattr(build, "_LIB", None)
        build.load_library()                     # the library on disk
    assert cached.count == 0
    assert build._build is fake_build


def test_build_watch_counts_compiles(monkeypatch):
    monkeypatch.setattr(torch, "compile", lambda fn, **kw: fn)
    with BuildWatch() as watch:
        torch.compile(abs)
        with pytest.raises(RuntimeError):
            BuildWatch().__enter__()
    assert [k for k, _ in watch.events] == ["torch.compile"]


# ---------------------------------------------------------------- the gate


def plant_dispatch_sync(monkeypatch, device="cpu"):
    """Plant one ``.item()`` in the dispatch scope of the watched drain."""
    from repro_torch.serving import solve_service

    orig = solve_service.solve_batch_submit
    planted = []

    def submit(*args, **kwargs):
        if SyncWatch._active is not None and not planted:
            planted.append(torch.zeros((), device=device).item())
        return orig(*args, **kwargs)

    monkeypatch.setattr(solve_service, "solve_batch_submit", submit)
    return planted


def test_service_gate_is_ok_on_the_cpu():
    report = tan.run_service_gate(device="cpu")
    assert report["ok"], report
    assert report["dispatch_syncs"] == 0 and report["post_warmup_builds"] == 0
    assert report["harvest_syncs"] > 0 and report["sync_counts"]["net_build"] > 0
    assert report["tickets"] == 12 and report["solve_errors"] == 0


def test_service_gate_counts_a_planted_dispatch_sync(monkeypatch):
    planted = plant_dispatch_sync(monkeypatch)
    report = tan.run_service_gate(device="cpu", n_streams=2)
    assert len(planted) == 1
    assert report["dispatch_syncs"] == 1
    assert not report["ok"]


def test_cli_runtime_gate_on_the_cpu(capsys):
    assert tan_cli.main(["--runtime-gate", "--device", "cpu"]) == 0
    assert "runtime gate ok" in capsys.readouterr().out


def test_settling_tickets_poll_under_settle_poll():
    from repro_torch.data.spd import random_rhs_from_solution, random_spd
    from repro_torch.serving import SolveService

    rng = np.random.default_rng(5)
    svc = SolveService(batch_slots=2, devices=["cpu"])
    for _ in range(2):
        a = random_spd(rng, 6)
        svc.submit(a, random_rhs_from_solution(rng, a)[1], method="analog_2n",
                   compute_settling=True, settle_method="euler", settle_max_steps=2000)
    with SyncWatch(device_type="cpu") as watch:
        out = svc.drain()
    assert all(hasattr(r, "x") for r in out.values())
    assert watch.total("settle_poll") > 0 and watch.total("dispatch") == 0
    assert {label for label, _ in watch.calls} <= {
        "net_build", "harvest", "finish", "settle_poll", "unpack"}


@pytest.mark.parametrize("method", ["cg", "jacobi", "cholesky"])
def test_digital_submit_copies_nothing_to_the_host(method):
    from repro_torch.core.solver import solve_batch, solve_batch_submit
    from repro_torch.data.spd import random_rhs_from_solution, random_sdd

    rng = np.random.default_rng(3)
    a = np.stack([random_sdd(rng, 8) for _ in range(3)])
    b = np.stack([random_rhs_from_solution(rng, ak)[1] for ak in a])
    with SyncWatch(device_type="cpu") as watch, sync_scope("dispatch"):
        pending = solve_batch_submit(a, b, method=method, device="cpu")
    assert watch.total("dispatch") == 0
    got, want = pending.wait(), solve_batch(a, b, method=method, device="cpu")
    assert np.array_equal(got.x, want.x)
    for key in want.info:
        assert np.array_equal(got.info[key], want.info[key])
