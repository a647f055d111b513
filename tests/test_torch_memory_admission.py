"""Port parity of the HBM admission (``paddle_tpu_torch.fault.memory``,
``cost_model.executable_memory``) on the CPU.

* ``preflight``, ``budget_bytes``, ``attributions``, ``last_prediction``
  and ``executable_memory`` against the reference's functions on the same
  ``mem`` dicts, with both packages' census patched to the same live
  bytes: the arithmetic (live + temp + output - max(alias, donated), plus
  ``hbm.pressure`` bytes), the returned numbers, the ``warn`` (once a site)
  and ``enforce`` policies with the message and its fields, and the
  counters, all exactly equal.
* ``jit.CompiledTrainStep`` and ``HybridParallelEngine`` under ``enforce``
  at a 10-byte budget: the first two calls measure, the third is rejected
  before anything changes (parameters, gradients, optimizer state, step
  counts, RNG stream bit-equal), and the same call with the budget raised
  equals an unadmitted run bit for bit. From a fresh optimizer, a budget
  just above the measured steady step's footprint admits the first
  admitted call: the gradients and optimizer state the first call built
  are counted once, in the live census.
* The post-mortem's and the flight context's contents, ``free_pressure``,
  the inert tripwire (with admission ``off`` nothing of it runs), and the
  serving engine's ``hbm_admission`` drift.
"""
import json
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu import profiler as jprofiler
from paddle_tpu.cost_model import executable_memory as jexec_mem
from paddle_tpu.fault import memory as jmem
import paddle_tpu_torch as pt
from paddle_tpu_torch import cost_model, profiler
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch.distributed import HybridParallelEngine
from paddle_tpu_torch.fault import inject
from paddle_tpu_torch.fault import memory
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.models import GPTConfig, GPTForPretraining, gpt_tiny
from torch_port_util import chaos, serve_flags

MEM = {"argument_bytes": 1000, "output_bytes": 300, "temp_bytes": 500,
       "alias_bytes": 100, "peak_bytes": 1700}


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    prev = flags.get_flags(["FLAGS_hbm_admission", "FLAGS_hbm_budget_bytes"])
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    yield
    inject.disarm()
    flags.set_flags(prev)


@pytest.fixture
def census(monkeypatch):
    """Both packages' census answer the same live bytes."""
    live = [0]

    def fake(*a, **k):
        return {"live_bytes": live[0]}

    monkeypatch.setattr(jprofiler, "memory_census", fake)
    monkeypatch.setattr(profiler, "memory_census", fake)
    return live


def _counts(c):
    return {k: c.get(k, 0) for k in ("hbm_admission_checks",
                                      "hbm_admission_rejects")}


def _both(where, mem, live, census, donated=0):
    """(reference, port) outcomes of one preflight: the returned dict or
    the exception's (message, fields), and the counters' moves."""
    census[0] = live
    out = []
    for mod, prof in ((jmem, jprofiler), (memory, profiler)):
        c0 = _counts(prof.counters())
        try:
            got = mod.preflight(mem, where, donated_bytes=donated)
        except Exception as e:
            got = (type(e).__name__, str(e), e.predicted_bytes,
                   e.live_bytes, e.budget_bytes, e.peak_bytes)
        c1 = _counts(prof.counters())
        out.append((got, {k: c1[k] - c0[k] for k in c1}))
    return out


@pytest.mark.parametrize("case", [
    # (mode, budget, live, mem, donated, pressure)
    ("enforce", 1 << 40, 2000, MEM, 0, 0),
    ("enforce", 2500, 2000, MEM, 0, 0),
    ("enforce", 2700, 2000, MEM, 0, 0),
    ("enforce", 2700, 2000, MEM, 400, 0),
    ("enforce", 2500, 2000, dict(MEM, alias_bytes=10 ** 6), 0, 0),
    ("enforce", 0, 10 ** 12, MEM, 0, 0),
    ("enforce", 1 << 20, 2000, MEM, 0, 1 << 21),
    ("warn", 1 << 40, 2000, MEM, 0, 0),
    ("enforce", 2500, 2000, None, 0, 0),
], ids=["admit", "reject", "edge", "donated", "alias_clamp", "no_budget",
        "chaos_pressure", "warn_admit", "no_prediction"])
def test_preflight_matches_reference(case, census):
    mode, budget, live, mem, donated, pressure = case
    spec = f"hbm.pressure:bytes={pressure}" if pressure else None
    with serve_flags(FLAGS_hbm_admission=mode, FLAGS_hbm_budget_bytes=budget):
        if spec:
            with chaos(spec):
                want, got = _both("lazy_flush", mem, live, census, donated)
        else:
            want, got = _both("lazy_flush", mem, live, census, donated)
    assert got == want
    if mem is not None and isinstance(got[0], dict):
        assert memory.last_prediction() == jmem.last_prediction()


def test_warn_warns_once_a_site_and_dispatches(census):
    where = "test_warn_site"
    with serve_flags(FLAGS_hbm_admission="warn", FLAGS_hbm_budget_bytes=10):
        for mod in (jmem, memory):
            with pytest.warns(RuntimeWarning, match="exceeds budget 10"):
                assert mod.preflight(MEM, where)["hbm_budget_bytes"] == 10
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                mod.preflight(MEM, where)


def test_budget_exceeded_carries_numbers():
    e = memory.HbmBudgetExceeded("train_step", 1000, 600, 800, 400)
    j = jmem.HbmBudgetExceeded("train_step", 1000, 600, 800, 400)
    assert str(e) == str(j)
    assert (e.predicted_bytes, e.live_bytes, e.budget_bytes,
            e.peak_bytes) == (1000, 600, 800, 400)


def test_budget_bytes_matches_reference():
    with serve_flags(FLAGS_hbm_budget_bytes=12345):
        assert memory.budget_bytes() == jmem.budget_bytes() == 12345
    with serve_flags(FLAGS_hbm_budget_bytes=0):
        # the CPU reports no capacity: no budget in either package
        assert memory.budget_bytes(refresh=True) == \
            jmem.budget_bytes(refresh=True) == 0


def test_attributions_and_executable_memory_match_reference():
    class Analysis:
        argument_size_in_bytes = 4096
        output_size_in_bytes = 1024
        temp_size_in_bytes = 2048
        alias_size_in_bytes = 512

    class Compiled:
        def memory_analysis(self):
            return Analysis()

    class Broken:
        def memory_analysis(self):
            raise RuntimeError("no analysis")

    assert cost_model.executable_memory(Compiled()) == jexec_mem(Compiled())
    assert cost_model.executable_memory(Broken()) is jexec_mem(Broken()) \
        is None
    big = 1 << 50
    for i, k in enumerate(("test_attr_a", "test_attr_b", "test_attr_c")):
        mem = dict(MEM, peak_bytes=big + i)
        memory.note_executable(k, mem)
        jmem.note_executable(k, mem)
    assert memory.attributions(top=3) == jmem.attributions(top=3)
    assert [r["key"] for r in memory.attributions(top=3)] == [
        "test_attr_c", "test_attr_b", "test_attr_a"]
    got = memory.analyze_compiled(Compiled(), key="test_attr_d")
    assert got == jmem.analyze_compiled(Compiled(), key="test_attr_d")
    assert got["peak_bytes"] == 4096 + 1024 + 2048 - 512


def test_measured_step_on_the_cpu_is_the_census_delta():
    keep = []
    with cost_model.MeasuredStep("cpu") as run:
        keep.append(torch.zeros(1000, dtype=torch.float32))
    mem = cost_model.executable_memory(run)
    assert mem["output_bytes"] >= 4000 and mem["temp_bytes"] == 0
    assert mem["alias_bytes"] == 0
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["output_bytes"]
    with pytest.raises(ValueError):
        with cost_model.MeasuredStep("cpu") as failed:
            raise ValueError("the call failed")
    assert cost_model.executable_memory(failed) is None


def _gpt(seed=3):
    cfg = gpt_tiny(hidden_dropout=0.1, attention_dropout=0.0)
    return GPTForPretraining(cfg, device="cpu", seed=seed).train()


def _batch():
    rng = np.random.RandomState(8)
    return (torch.from_numpy(rng.randint(0, 1024, (2, 16)).astype(np.int64)),
            torch.from_numpy(rng.randint(0, 1024, (2, 16)).astype(np.int64)))


def _state(m, opt, step):
    return ([p.detach().clone() for p in m.parameters()],
            [None if p.grad is None else p.grad.clone()
             for p in m.parameters()],
            {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in opt.state_dict().items()},
            opt._step_count, getattr(step, "_step_count", None),
            pt.core.random.get_rng_state())


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _make(kind, m, opt):
    if kind == "jit":
        return tjit.compile_train_step(m, lambda mm, i, l: mm.loss(i, l), opt)
    eng = HybridParallelEngine(m, opt, lambda mm, i, l: mm.loss(i, l))
    return eng.train_step


@pytest.mark.parametrize("kind", ["jit", "engine"])
def test_enforce_rejects_before_the_step_then_retries_bit_equal(kind):
    ids, labels = _batch()
    pt.seed(0)
    m0 = _gpt()
    opt0 = pt.optimizer.AdamW(1e-3, parameters=m0.parameters())
    step0 = _make(kind, m0, opt0)
    want = [step0(ids, labels) for _ in range(3)]

    pt.seed(0)
    m = _gpt()
    opt = pt.optimizer.AdamW(1e-3, parameters=m.parameters())
    step = _make(kind, m, opt)
    flags.set_flags({"FLAGS_hbm_admission": "enforce",
                     "FLAGS_hbm_budget_bytes": 10})
    r0 = profiler.counters().get("hbm_admission_rejects", 0)
    # measured, not admitted: the first builds the state, the second is
    # the steady step later calls are admitted with
    first = [step(ids, labels) for _ in range(2)]
    owner = step if kind == "jit" else step.__self__
    before = _state(m, opt, owner)
    with pytest.raises(memory.HbmBudgetExceeded,
                       match=r"predicted \d+ bytes .* exceeds budget 10"):
        step(ids, labels)
    assert profiler.counters().get("hbm_admission_rejects", 0) == r0 + 1
    assert _same(_state(m, opt, owner), before)
    flags.set_flags({"FLAGS_hbm_budget_bytes": 1 << 60})
    third = step(ids, labels)
    assert all(torch.equal(a, b) for a, b in zip(first + [third], want))
    assert all(torch.equal(a, b)
               for a, b in zip(m.parameters(), m0.parameters()))
    rows = [r for r in memory.attributions(top=256)
            if r["key"].startswith("train_step:" if kind == "jit"
                                   else "engine.step:x1:")]
    assert rows and rows[0]["temp_bytes"] == 0 and rows[0]["alias_bytes"] == 0


@pytest.mark.parametrize("kind", ["jit", "engine"])
def test_a_fresh_step_is_admitted_just_above_its_steady_footprint(kind):
    """Fresh AdamW under ``enforce``: the first call builds the gradients
    and the moments (its measured growth), the second measures the steady
    step. With the budget 1 KiB above the live census plus the second's
    extra bytes, the third call is admitted; admitting with the first
    call's growth would have counted the gradients and moments twice and
    rejected it."""
    ids, labels = _batch()
    pt.seed(0)
    m = _gpt()
    opt = pt.optimizer.AdamW(1e-3, parameters=m.parameters())
    step = _make(kind, m, opt)
    flags.set_flags({"FLAGS_hbm_admission": "enforce",
                     "FLAGS_hbm_budget_bytes": 1 << 60})
    prefix = "train_step:" if kind == "jit" else "engine.step:x1:"

    def row():
        return next(r for r in memory.attributions(top=256)
                    if r["key"].startswith(prefix))

    losses = [step(ids, labels)]
    growth = row()["output_bytes"]
    state = sum(p.numel() * p.element_size() for p in m.parameters()) * 3
    assert growth >= state  # the gradients and both moments
    losses.append(step(ids, labels))
    steady = row()
    assert steady["output_bytes"] < 1024 and steady["temp_bytes"] == 0
    live = profiler.memory_census("cpu")["live_bytes"]
    flags.set_flags({"FLAGS_hbm_budget_bytes":
                     live + steady["output_bytes"] + 1024})
    losses.append(step(ids, labels))
    pred = memory.last_prediction()
    assert pred["hbm_live_bytes"] == live
    assert pred["hbm_predicted_peak_bytes"] == live + steady["output_bytes"]
    assert live + growth > pred["hbm_budget_bytes"]
    assert all(torch.isfinite(x) for x in losses)


def test_cpu_census_skips_a_dead_weak_proxy():
    """A ``weakref.proxy`` whose referent is gone raises ``ReferenceError``
    on ``isinstance``; the CPU census walks past it and still counts a
    live tensor's storage."""
    import gc
    import weakref

    class Obj:
        pass

    o = Obj()
    held = [weakref.proxy(o)]
    del o
    gc.collect()
    with pytest.raises(ReferenceError):
        isinstance(held[0], torch.Tensor)
    before = profiler.memory_census("cpu")["live_bytes"]
    t = torch.zeros(1 << 16)
    assert profiler.memory_census("cpu")["live_bytes"] >= before \
        + t.nbytes - 1
    assert held


def test_post_mortem_carries_the_budget_and_the_attributions(census):
    memory.note_executable("test_pm_key", dict(MEM, peak_bytes=1 << 51))
    census[0] = 777
    with serve_flags(FLAGS_hbm_admission="warn",
                     FLAGS_hbm_budget_bytes=1 << 40):
        memory.preflight(MEM, "test_pm")
        path = memory.post_mortem("engine.step", [{"action": "classify"}],
                                  RuntimeError("out of memory"))
        doc = json.loads(open(path).read())
    ex = doc["extra"]
    assert doc["reason"] == "hbm_exhausted" and ex["where"] == "engine.step"
    assert ex["budget_bytes"] == 1 << 40
    assert ex["attributions"][0]["key"] == "test_pm_key"
    assert ex["attempts"] == [{"action": "classify"}]
    assert "device" in ex["census"]
    hbm = doc["context"]["hbm"]
    assert hbm["last_prediction"]["hbm_live_bytes"] == 777
    assert hbm["budget_bytes"] == 1 << 40 and hbm["attributions"]


def test_free_pressure_drops_the_failed_steps_gradients():
    w = torch.nn.Parameter(torch.ones(256, 256))
    (w * 2).sum().backward()
    got = memory.free_pressure("test", params=[w])
    assert w.grad is None
    assert got["evicted_executables"] == 0
    assert got["freed_grad_bytes"] == 256 * 256 * 4
    assert {"reason", "handlers", "released_bytes",
            "live_bytes"} <= set(got)


class TestInertTripwire:
    def test_unconfigured_loop_never_touches_admission_or_the_ladder(
            self, monkeypatch):
        """FLAGS_hbm_admission=off (default) + nothing armed: the
        classifier, the preflight, the measurement and the pressure rung
        are never called (exploded here), no census runs, and no hbm
        counter moves."""
        assert flags.flag("FLAGS_hbm_admission") == "off"

        def boom(*a, **k):
            raise AssertionError("fault.memory touched without admission/OOM")

        for name in ("preflight", "classify", "is_oom", "free_pressure",
                     "analyze_compiled", "note_executable"):
            monkeypatch.setattr(memory, name, boom)
        monkeypatch.setattr(cost_model, "MeasuredStep", boom)
        censuses0 = profiler.memory_stats().get("censuses", 0)
        c0 = profiler.counters()
        ids, labels = _batch()
        m = _gpt()
        opt = pt.optimizer.AdamW(1e-3, parameters=m.parameters())
        step = tjit.compile_train_step(m, lambda mm, i, l: mm.loss(i, l),
                                       opt)
        for _ in range(2):
            step(ids, labels)
        eng = HybridParallelEngine(m, opt, lambda mm, i, l: mm.loss(i, l))
        for _ in range(2):
            eng.train_step(ids, labels)
        loss = m.loss(ids, labels)  # the eager loop is never admitted
        loss.backward()
        opt.step()
        assert profiler.memory_stats().get("censuses", 0) == censuses0
        c1 = profiler.counters()
        for k in ("hbm_admission_checks", "hbm_admission_rejects",
                  "hbm_oom_trips", "hbm_oom_recoveries",
                  "hbm_degraded_steps"):
            assert c1.get(k, 0) == c0.get(k, 0)


def test_serving_engine_records_the_hbm_admission_drift():
    from paddle_tpu_torch.serving import Engine, observe

    observe.reset()
    m = GPTForPretraining(GPTConfig(vocab_size=211, hidden_size=32,
                                    num_layers=2, num_heads=2,
                                    max_position_embeddings=64),
                          device="cpu", seed=0).eval()
    kw = dict(device="cpu", block_size=8, num_blocks=32, max_batch=4,
              max_seq_len=64, trace=True)
    try:
        with Engine(m, **kw) as eng:  # admission off: no drift
            eng.generate([1, 2, 3], max_new_tokens=3)
        assert "hbm_admission" not in observe.drift_gauges()
        flags.set_flags({"FLAGS_hbm_admission": "warn",
                         "FLAGS_hbm_budget_bytes": 1 << 60})
        # a step program's preflight seeds the prediction
        ids, labels = _batch()
        t = _gpt()
        step = tjit.compile_train_step(
            t, lambda mm, i, l: mm.loss(i, l),
            pt.optimizer.SGD(0.0, parameters=t.parameters()))
        for _ in range(3):  # two measured calls, then one admitted
            step(ids, labels)
        assert memory.last_prediction().get("hbm_predicted_peak_bytes")
        with Engine(m, **kw) as eng:
            eng.generate([4, 5, 6], max_new_tokens=4)
        g = observe.drift_gauges()["hbm_admission"]
        assert g["samples"] >= 1 and g["rel_err"] >= 0.0
        assert g["predicted"] == memory.last_prediction()[
            "hbm_predicted_peak_bytes"]
    finally:
        observe.reset()
