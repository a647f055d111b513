"""The port's ``analysis`` against the reference's: the linter's seven rules
and the lock checker on the reference's own seeded fixtures
(``tests/test_analysis.py``) give the same findings in both packages, the
runtime ownership checks (``FLAGS_thread_checks``) hold, and the tripwire:
``run_all()`` over ``paddle_tpu_torch`` is clean.

The reference's eighth rule, ``compat-shim``, polices its JAX shim and has
no counterpart; ``oom-handler`` names ``torch.OutOfMemoryError`` where the
reference names ``XlaRuntimeError``, so a fixture's ``XlaRuntimeError``
reads ``OutOfMemoryError`` on the port's side.
"""
import ast
import os
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401
from paddle_tpu.analysis import lint as jlint
from paddle_tpu.analysis import locks as jlocks

from paddle_tpu_torch import analysis
from paddle_tpu_torch.analysis import lint, locks, thread_checks
from paddle_tpu_torch.framework import flags
from torch_port_util import cpu_device

REF_TESTS = Path(__file__).resolve().parent / "test_analysis.py"


def _fixtures():
    """The seeded sources of the reference's analysis tests: every string
    constant there that is a Python module with a function in it."""
    out = []
    for node in ast.walk(ast.parse(REF_TESTS.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "\n" in node.value and "def " in node.value:
            src = textwrap.dedent(node.value)
            try:
                ast.parse(src)
            except SyntaxError:
                continue
            out.append((node.lineno, src))
    return out


FIXTURES = _fixtures()
# the scopes the rules key on, and paths outside every scope
# (the reference's core/lazy.py, in its oom-handler scope, is not in the port)
RELPATHS = ["core/foo.py", "distributed/foo.py", "optimizer/foo.py",
            "hapi/foo.py", "fault/retry.py", "distributed/checkpoint.py",
            "distributed/watchdog.py", "core/dispatch.py",
            "serving/engine.py", "serving/supervisor.py",
            "distributed/engine.py", "framework/flags.py",
            "profiler/__init__.py"]


def _key(findings):
    return sorted((f.rule, f.line, f.scope) for f in findings
                  if f.rule != "compat-shim")


def _port_src(src):
    return src.replace("XlaRuntimeError", "OutOfMemoryError")


def test_the_fixtures_were_found():
    assert len(FIXTURES) >= 30
    assert lint.RULES == tuple(r for r in jlint.RULES if r != "compat-shim")


@pytest.mark.parametrize("line,src", FIXTURES, ids=[f"L{ln}"
                                                    for ln, _ in FIXTURES])
def test_lint_findings_equal_the_reference(line, src):
    for rel in RELPATHS:
        want = _key(jlint.lint_source(src, rel)[0])
        got = _key(lint.lint_source(_port_src(src), rel)[0])
        assert got == want, rel
    # the flag references the cross-file rule resolves
    assert lint.lint_source(src, "mod.py")[1] == \
        jlint.lint_source(src, "mod.py")[1]


@pytest.mark.parametrize("line,src", [f for f in FIXTURES
                                      if "guarded_by" in f[1]],
                         ids=lambda v: f"L{v}" if isinstance(v, int) else "")
def test_lock_findings_equal_the_reference(line, src):
    got = locks.check_source(src, "x.py")
    want = jlocks.check_source(src, "x.py")
    assert [(f.rule, f.line, f.scope, f.message) for f in got] == \
        [(f.rule, f.line, f.scope, f.message) for f in want]


def _write_pkg(root, files):
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return str(root)


def _counter_pkg(registered, documented, mod_src):
    doc = ", ".join(f"``{n}``" for n in documented)
    return {
        "profiler/__init__.py": (
            "def counters():\n"
            f'    """Counter snapshot.\n\n    Telemetry: {doc}.\n    """\n'
            "    return {}\n\n"
            "KNOWN_COUNTERS = frozenset({"
            + ", ".join(repr(n) for n in sorted(registered)) + "})\n"),
        "mod.py": mod_src,
    }


PACKAGES = {
    "flags": {
        "framework/flags.py": '_FLAGS = {"FLAGS_known": True}\n'
                              "def register_flag(name, default):\n"
                              "    pass\n",
        "mod.py": "from .framework import flags as _flags\n"
                  '_flags.register_flag("FLAGS_runtime_added", 0)\n'
                  'A = _flags.flag("FLAGS_known", True)\n'
                  'B = _flags.flag("FLAGS_runtime_added", 1)\n'
                  'C = _flags.flag("FLAGS_typo_nver_registered", None)\n'},
    "counter_unregistered": _counter_pkg({"good"}, {"good"}, """
        from .profiler import counter_inc
        def f():
            counter_inc("good")
            counter_inc("ghost")
        """),
    "counter_stale": _counter_pkg({"good", "stale"}, {"good", "stale"}, """
        from .profiler import counter_inc
        def f():
            counter_inc("good")
        """),
    "counter_undocumented": _counter_pkg({"good", "undoc"}, {"good"}, """
        from .profiler import counter_inc
        def f():
            counter_inc("good")
            counter_inc("undoc")
        """),
    "counter_ifexp": _counter_pkg({"a"}, {"a"}, """
        from .profiler import counter_inc
        def f(kind):
            counter_inc("a" if kind == "wedge" else "b")
        """),
    "counter_step_counters": _counter_pkg({"other"}, {"other"}, """
        from .profiler import counter_inc
        def step_counters():
            return {"sc_a": 1}
        def g():
            counter_inc("other")
        """),
    "no_registry": {"mod.py": "from x import counter_inc\n"
                              'counter_inc("anything_at_all")\n'},
    "baseline_scope": {"core/foo.py": "def hot(t):\n    return t.numpy()\n"
                                      "def other(t):\n"
                                      "    return t.numpy()\n"},
}


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_package_rules_equal_the_reference(name, tmp_path):
    root = _write_pkg(tmp_path / "pkg", PACKAGES[name])
    base = [("host-sync", "core/foo.py", "hot")]
    want = jlint.lint_package(root, baseline=base)
    got = lint.lint_package(root, baseline=base)
    # host-sync's message names the port's readback funnel
    assert [(f.rule, f.path, f.line, f.scope,
             f.message if f.rule != "host-sync" else "") for f in got] == \
        [(f.rule, f.path, f.line, f.scope,
          f.message if f.rule != "host-sync" else "") for f in want]
    assert want or name in ("no_registry",)


def test_baseline_grammar(tmp_path):
    p = tmp_path / "baseline.txt"
    p.write_text("host-sync\tcore/foo.py\thot\n")
    with pytest.raises(ValueError, match="justification"):
        lint.load_baseline(str(p))
    p.write_text("compat-shim\tcore/foo.py\thot\t# no such rule here\n")
    with pytest.raises(ValueError, match="unknown rule"):
        lint.load_baseline(str(p))


# -- the tripwire -------------------------------------------------------------
def test_the_port_has_no_unsuppressed_findings():
    findings = analysis.run_all()
    assert findings == [], "\n".join(map(repr, findings))
    assert analysis.package_root().endswith("paddle_tpu_torch")


def test_every_baseline_entry_is_justified_and_live():
    entries = lint.load_baseline(analysis.baseline_path())
    assert entries
    root = analysis.package_root()
    raw = {f.key() for f in lint.lint_package(root)
           + locks.check_lock_discipline(root)}
    assert [e for e in entries if e not in raw] == []


def test_cli(capsys):
    from paddle_tpu_torch.analysis.__main__ import main

    assert main([]) == 0
    assert "analysis clean" in capsys.readouterr().out
    assert main(["--no-baseline"]) == 1
    out = capsys.readouterr().out
    assert "host-sync" in out and "baseline" in out


def test_the_annotations_are_checked():
    root = analysis.package_root()
    n = 0
    for path in lint.iter_py_files(root):
        n += len(locks.collect_annotations(Path(path).read_text()))
    assert n >= 40
    assert locks.check_lock_discipline(root) == []


def test_known_counters_cover_every_bump():
    from paddle_tpu_torch import profiler

    findings = [f for f in lint.lint_package(analysis.package_root())
                if f.rule in ("counter-registry", "flag-registry")]
    assert findings == []
    assert len(profiler.KNOWN_COUNTERS) >= 100


# -- runtime ownership assertions (FLAGS_thread_checks) -----------------------
@pytest.fixture
def thread_checks_on():
    flags.set_flags({"FLAGS_thread_checks": True})
    yield
    flags.set_flags({"FLAGS_thread_checks": False})


def test_flag_off_is_identity():
    assert flags.flag("FLAGS_thread_checks") is False
    d = {}
    assert thread_checks.guarded(d, threading.Lock(), "t") is d
    assert thread_checks.owned(d, "t") is d
    assert thread_checks.unwrap(d) is d


def test_guarded_mutation_requires_lock(thread_checks_on):
    lk = threading.RLock()
    d = thread_checks.guarded({}, lk, "test.table")
    assert thread_checks.guarded(d, lk) is d  # no stacked proxies
    with pytest.raises(thread_checks.OwnershipError):
        d["k"] = 1
    with lk:
        d["k"] = 1
        d.update(z=2)
        del d["z"]
    assert d["k"] == 1 and "k" in d and len(d) == 1


def test_racy_mutation_fails_deterministically(thread_checks_on):
    lk = threading.RLock()
    table = thread_checks.guarded({}, lk, "racy.table")
    errors = []

    def disciplined():
        for i in range(50):
            with lk:
                table[f"d{i}"] = i

    def racy():
        try:
            for i in range(50):
                table[f"r{i}"] = i
        except thread_checks.OwnershipError as e:
            errors.append(e)

    ts = [threading.Thread(target=disciplined), threading.Thread(target=racy)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(errors) == 1
    assert not any(k.startswith("r") for k in table)


def test_augmented_assignment_and_requires_lock(thread_checks_on):
    lk = threading.RLock()
    lst = thread_checks.guarded([1], lk, "aug")
    st = thread_checks.guarded({1}, lk, "aug-set")
    with pytest.raises(thread_checks.OwnershipError):
        lst += [2]
    with pytest.raises(thread_checks.OwnershipError):
        st |= {2}
    with lk:
        lst += [2]
        st |= {2}
    assert list(lst) == [1, 2] and 2 in st

    @thread_checks.requires_lock(lk, name="lk")
    def helper(d):
        d["x"] = 1

    with pytest.raises(thread_checks.OwnershipError):
        helper({})
    with lk:
        d = {}
        helper(d)
    assert d == {"x": 1}


def test_owned_structure_pins_its_owner(thread_checks_on):
    box = thread_checks.owned([0], "counter")
    box[0] += 1
    caught = []

    def foreign():
        try:
            box[0] += 1
        except thread_checks.OwnershipError as e:
            caught.append(e)

    t = threading.Thread(target=foreign)
    t.start()
    t.join()
    assert len(caught) == 1 and "owned by" in str(caught[0])
    assert box[0] == 1


def test_watchdog_tables_wrapped_under_flag(thread_checks_on, tmp_path):
    from paddle_tpu_torch.distributed import watchdog

    watchdog.reset()
    try:
        watchdog.configure(rank=0, world_size=1, store=None,
                           progress_dir=str(tmp_path))
        watchdog.publish(step=1, phase="test", force=True)
        assert watchdog.local_progress()["step"] == 1
        with pytest.raises(thread_checks.OwnershipError):
            watchdog._guards[99] = (0.0, "rogue")
        with pytest.raises(thread_checks.OwnershipError):
            watchdog._local["step"] = 7
    finally:
        watchdog.reset()
    assert type(watchdog._guards) is dict and type(watchdog._local) is dict


def test_watchdog_tables_plain_with_the_flag_off(tmp_path):
    from paddle_tpu_torch.distributed import watchdog

    watchdog.reset()
    try:
        watchdog.configure(rank=0, world_size=1, store=None,
                           progress_dir=str(tmp_path))
        assert type(watchdog._guards) is dict
        assert type(watchdog._local) is dict
    finally:
        watchdog.reset()


def _prefetcher(n=4):
    from paddle_tpu_torch.io import DevicePrefetcher

    with cpu_device():
        return DevicePrefetcher(iter([np.full((2, 2), i, np.float32)
                                      for i in range(n)]))


def test_device_prefetcher_raises_on_a_foreign_consumer(thread_checks_on):
    p = _prefetcher()
    try:
        batch = next(p)  # this thread becomes the consumer
        assert tuple(batch.shape) == (2, 2)
        caught = []

        def foreign():
            try:
                next(p)
            except thread_checks.OwnershipError as e:
                caught.append(e)

        t = threading.Thread(target=foreign)
        t.start()
        t.join()
        assert len(caught) == 1 and "DevicePrefetcher._consumed" in \
            str(caught[0])
        assert p._consumed[0] == 1
    finally:
        p.close()


def test_device_prefetcher_plain_with_the_flag_off():
    p = _prefetcher()
    try:
        out = []
        t = threading.Thread(target=lambda: out.append(next(p)))
        next(p)
        t.start()
        t.join()
        assert len(out) == 1 and p._consumed == [2]
    finally:
        p.close()


def test_device_prefetcher_rewraps_at_load_state_dict(thread_checks_on):
    from paddle_tpu_torch.io import DataLoader, DevicePrefetcher, TensorDataset

    ds = TensorDataset([torch.arange(8, dtype=torch.float32)[:, None]])
    with cpu_device():
        loader = DataLoader(ds, batch_size=2)
        p = DevicePrefetcher(loader)
        next(p)
        sd = p.state_dict()
        p.load_state_dict(sd)
        assert isinstance(p._consumed, thread_checks._CheckedProxy)
        next(p)
        caught = []

        def foreign():
            try:
                next(p)
            except thread_checks.OwnershipError as e:
                caught.append(e)

        t = threading.Thread(target=foreign)
        t.start()
        t.join()
        p.close()
    assert len(caught) == 1


def test_no_reference_path_in_the_analysis():
    """The port's analysis imports nothing of the reference's."""
    for name in ("__init__.py", "__main__.py", "lint.py", "locks.py",
                 "thread_checks.py"):
        tree = ast.parse(Path(os.path.dirname(lint.__file__), name)
                         .read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                assert not (node.module or "").startswith("paddle_tpu.")
