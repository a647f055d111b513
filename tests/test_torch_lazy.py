"""The port's lazy eager engine (``paddle_tpu_torch/core/lazy.py``) held
against the reference's (``paddle_tpu/core/lazy.py``) and against its own
eager run, on the CPU.

With lazy mode on in both packages, the reference's ``test_lazy.py`` MLP
loop (Adam) and the tiny GPT's AdamW loop with a per-step lr schedule run
from the same weights (loaded by name) and the same numpy batches: losses
and parameters agree within rtol 1e-5 (MLP) and 1e-4 (the GPT, as
``test_torch_paddle_api_train.py`` holds its loop). In the port, lazy on
is bit-equal to lazy off, and the graph cache stops growing after the
second iteration while the learning rate changes every step (the
optimizers' step-dependent scalars are leaves, not signature parts).
Materialization (``.item()``, ``.numpy()``, ``print``, ``bool``,
``tolist``, ``paddle.save``) sees a pending update; backward twice
raises, ``retain_graph`` works, micro-batch accumulation matches; the
graph cache's transitions (sight, capture, replay, fallback, evict) are
checked on the device-neutral bookkeeping; the default is off.
"""
import io
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu.core import lazy as jlazy
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
from paddle_tpu_torch import profiler
from paddle_tpu_torch.core import lazy
from paddle_tpu_torch.models import load_reference_state_dict
from torch_port_util import cpu_device, port_of, reference_state

STEPS = 4


@pytest.fixture(autouse=True)
def _cpu_lazy_off():
    with cpu_device():
        yield
    lazy.set_lazy_mode(False)
    jlazy.set_lazy_mode(True)


class JMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(16, 32)
        self.fc2 = jnn.Linear(32, 10)

    def forward(self, x):
        return self.fc2(JF.relu(self.fc1(x)))


class TMLP(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(16, 32)
        self.fc2 = tnn.Linear(32, 10)

    def forward(self, x):
        return self.fc2(TF.relu(self.fc1(x)))


def _mlp_batch(i):
    x = np.random.RandomState(i).randn(8, 16).astype(np.float32)
    y = np.random.RandomState(100 + i).randint(0, 10, (8,)).astype(np.int64)
    return x, y


def _ref_mlp():
    paddle.seed(7)
    return JMLP()


def _port_mlp(jm):
    m = TMLP()
    load_reference_state_dict(m, reference_state(jm))
    return m


def _train_mlp(pkg, m, on, steps=STEPS):
    """The reference test_lazy.py loop: Adam(0.01), a fresh batch a step,
    the loss read each step."""
    (lazy if pkg is tp else jlazy).set_lazy_mode(on)
    opt = pkg.optimizer.Adam(learning_rate=0.01, parameters=m.parameters())
    losses = []
    for i in range(steps):
        x, y = (pkg.to_tensor(a) for a in _mlp_batch(i))
        F = TF if pkg is tp else JF
        loss = F.cross_entropy(m(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()) if pkg is paddle
                      else float(loss.detach()))
    (lazy if pkg is tp else jlazy).set_lazy_mode(pkg is paddle)
    return losses


def _params(m):
    return [np.array(p.detach().numpy()) for p in m.parameters()]


def _ref_params(m):
    return [np.asarray(p.numpy(), np.float32) for p in m.parameters()]


LR, T_MAX, WARMUP = 3e-3, 8, 2
GB, GT = 2, 32


def _gpt_batch():
    rng = np.random.RandomState(5)
    return (rng.randint(0, 1024, (GB, GT)).astype(np.int64),
            rng.randint(0, 1024, (GB, GT)).astype(np.int64))


def _ref_gpt():
    paddle.seed(3)
    return JGPT(jgpt_tiny(hidden_dropout=0.0, attention_dropout=0.0,
                          attention_impl="exact"))


def _adamw(pkg, model):
    sched = pkg.optimizer.lr.LinearWarmup(
        pkg.optimizer.lr.CosineAnnealingDecay(LR, T_max=T_MAX),
        warmup_steps=WARMUP, start_lr=0.0, end_lr=LR)
    opt = pkg.optimizer.AdamW(learning_rate=sched,
                              parameters=model.parameters(),
                              weight_decay=0.01)
    return opt, sched


def _train_gpt(pkg, model, on, steps=6, after_step=None):
    mod = lazy if pkg is tp else jlazy
    opt, sched = _adamw(pkg, model)
    ids, labels = (pkg.to_tensor(a) for a in _gpt_batch())
    mod.set_lazy_mode(on)
    losses, lrs = [], []
    try:
        for i in range(steps):
            lrs.append(opt.get_lr())
            loss = model.loss(ids, labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            sched.step()
            losses.append(loss.detach())
            if pkg is tp:
                lazy.flush()
            if after_step is not None:
                after_step(i)
    finally:
        mod.set_lazy_mode(pkg is paddle)
    vals = [float(np.asarray(x.numpy())) if pkg is paddle else float(x)
            for x in losses]
    return vals, lrs


# -- parity with the reference ---------------------------------------------
def test_mlp_adam_loop_matches_the_reference_lazy_loop():
    jm = _ref_mlp()
    tm = _port_mlp(jm)
    want = _train_mlp(paddle, jm, True)
    got = _train_mlp(tp, tm, True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for a, b in zip(_params(tm), _ref_params(jm)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_gpt_adamw_schedule_matches_the_reference_lazy_loop():
    jm = _ref_gpt()
    tm = port_of(jm, attention_impl="exact").train()
    want, jlrs = _train_gpt(paddle, jm, True)
    got, tlrs = _train_gpt(tp, tm, True)
    assert tlrs == jlrs
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # Adam's first steps move a parameter by about lr * sign(g): where a
    # gradient is within rounding of 0, the two packages may step apart by
    # up to 2 lr, so the parameters are held by their largest difference
    state = reference_state(jm)
    worst = max(float(np.abs(p.detach().numpy() - state[name]).max())
                for name, p in tm.named_parameters())
    assert worst < 1e-4, worst


# -- lazy on against lazy off, and the signature cache --------------------------
@pytest.mark.parametrize("model", ["mlp", "gpt"])
def test_lazy_on_is_bit_equal_to_lazy_off(model):
    runs = {}
    for on in (False, True):
        if model == "mlp":
            tm = _port_mlp(_ref_mlp())
            losses = _train_mlp(tp, tm, on)
        else:
            tm = port_of(_ref_gpt(), attention_impl="exact").train()
            losses, _ = _train_gpt(tp, tm, on)
        runs[on] = (losses, _params(tm))
    assert runs[True][0] == runs[False][0]
    for a, b in zip(runs[True][1], runs[False][1]):
        np.testing.assert_array_equal(a, b)


def test_signature_cache_stops_growing_after_iteration_two():
    """The lr changes every step (warm-up, then cosine): were it a Python
    float in the update, each step would be a new signature."""
    lazy.evict_cold(0)
    sizes = []
    tm = port_of(_ref_gpt(), attention_impl="exact").train()
    c0 = profiler.counters()
    _, lrs = _train_gpt(tp, tm, True, steps=7,
                        after_step=lambda i: sizes.append(
                            len(lazy._flush_cache)))
    assert all(a != b for a, b in zip(lrs, lrs[1:]))  # a new lr every step
    assert sizes[2:] == [sizes[1]] * (len(sizes) - 2), sizes
    hits = profiler.counters().get("lazy_cache_hits", 0) - c0.get(
        "lazy_cache_hits", 0)
    assert hits >= 5


def test_recorded_ops_and_the_step_boundary():
    tm = _port_mlp(_ref_mlp())
    x, y = (tp.to_tensor(a) for a in _mlp_batch(0))
    lazy.set_lazy_mode(True)
    r0 = lazy.recorded_ops()
    loss = TF.cross_entropy(tm(x), y)
    assert lazy.is_lazy(loss) and loss._concrete is None
    assert lazy.pending_summary()["pending_nodes"] == lazy.recorded_ops() - r0
    lazy.flush()
    assert loss._concrete is not None
    assert lazy.pending_summary()["pending_nodes"] == 0


# -- materialization points --------------------------------------------------
def _pending_update():
    """A parameter whose Adam update is recorded but not run, and the value
    it must read as (the same step with lazy off)."""
    want_m = _port_mlp(_ref_mlp())
    _train_mlp(tp, want_m, False, steps=1)
    m = _port_mlp(_ref_mlp())
    opt = tp.optimizer.Adam(learning_rate=0.01, parameters=m.parameters())
    x, y = (tp.to_tensor(a) for a in _mlp_batch(0))
    lazy.set_lazy_mode(True)
    loss = TF.cross_entropy(m(x), y)
    loss.backward()
    opt.step()
    opt.clear_grad()
    assert lazy.pending_summary()["pending_nodes"] > 0
    return m, want_m


@pytest.mark.parametrize("read", ["item", "numpy", "print", "bool", "tolist",
                                  "save"])
def test_host_reads_see_the_pending_update(read, tmp_path):
    m, want_m = _pending_update()
    p, want = m.fc1.bias, want_m.fc1.bias.detach().numpy()
    if read == "item":
        got = np.array([p[i].item() for i in range(3)], np.float32)
        want = want[:3]
    elif read == "numpy":
        got = p.detach().numpy()
    elif read == "print":
        buf = io.StringIO()
        print(p.detach()[:2], file=buf)
        assert lazy.pending_summary()["pending_nodes"] == 0
        got = p.detach().numpy()[:2]
        want = want[:2]
        assert f"{want[0]:.4f}" in buf.getvalue()
    elif read == "bool":
        assert bool((p == torch.from_numpy(want)).all())
        got = want
    elif read == "tolist":
        got = np.array(p.detach().tolist(), np.float32)
    else:
        path = str(tmp_path / "m.pdparams")
        tp.save(m.state_dict(), path)
        lazy.set_lazy_mode(False)
        got = np.asarray(tp.load(path)["fc1.bias"].numpy())
    np.testing.assert_array_equal(got, want)


def test_arithmetic_stays_lazy_and_is_right():
    t = tp.to_tensor(np.arange(8, dtype=np.float32))
    lazy.set_lazy_mode(True)
    a = t * 2.0
    assert lazy.is_lazy(a)
    for expr in (a + 1.0, 1.0 + a, a - 1.0, a * 3.0, -a, a / 2.0, a ** 2,
                 a[2]):
        assert lazy.is_lazy(expr)
    np.testing.assert_allclose((a + 1.0).numpy(), np.arange(8) * 2.0 + 1.0)
    np.testing.assert_allclose(float(a[1]), 2.0)


def test_data_dependent_ops_are_materialization_points():
    t = tp.to_tensor(np.array([0.0, 1.0, 0.0, 3.0], np.float32))
    lazy.set_lazy_mode(True)
    u = t * 2.0
    nz = torch.nonzero(u)  # flushes, then runs on the values
    assert not lazy.is_lazy(nz) and nz.flatten().tolist() == [1, 3]
    assert u._concrete is not None
    o = torch.ones(3)
    before = lazy.pending_summary()["pending_nodes"]
    with pytest.raises(RuntimeError):
        t + o  # a shape error at the call site, the graph left as it was
    assert lazy.pending_summary()["pending_nodes"] == before


# -- backward -------------------------------------------------------------------
def _w(v):
    w = tp.to_tensor(np.array(v, np.float32))
    w.stop_gradient = False
    return w


def test_backward_twice_raises():
    w = _w([2.0])
    lazy.set_lazy_mode(True)
    loss = (w * 3.0).sum()
    loss.backward()
    with pytest.raises(RuntimeError):
        loss.backward()


def test_retain_graph_allows_a_second_backward():
    w = _w([2.0])
    lazy.set_lazy_mode(True)
    loss = (w * 3.0).sum()
    loss.backward(retain_graph=True)
    loss.backward()
    np.testing.assert_allclose(w.grad.numpy(), [6.0])


def test_deep_chain_and_hooks():
    t = _w(np.ones(3))
    lazy.set_lazy_mode(True)
    z = t
    for _ in range(1500):
        z = z * 1.0001
    z.sum().backward()
    assert np.isfinite(t.grad.numpy()).all()
    w = _w([2.0])
    w.register_hook(lambda g: g * 2)
    ((w * w).sum()).backward()
    np.testing.assert_allclose(w.grad.numpy(), [8.0])
    v = _w([2.0])
    h = v * 3.0
    h.register_hook(lambda g: g * 10)
    (h * 1.0).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), [30.0])


def test_microbatch_gradient_accumulation_matches_eager():
    grads = {}
    for on in (False, True):
        m = _port_mlp(_ref_mlp())
        lazy.set_lazy_mode(on)
        for i in range(3):
            x, y = (tp.to_tensor(a) for a in _mlp_batch(i))
            TF.cross_entropy(m(x), y).backward()
            if i == 1:
                lazy.flush()  # a flush between micro-batches
        lazy.set_lazy_mode(False)
        grads[on] = [p.grad.numpy().copy() for p in m.parameters()]
    for a, b in zip(grads[True], grads[False]):
        np.testing.assert_array_equal(a, b)


# -- interop --------------------------------------------------------------------
def test_compiled_step_after_lazy_eager_steps():
    m = _port_mlp(_ref_mlp())
    opt = tp.optimizer.AdamW(learning_rate=1e-3, parameters=m.parameters())
    x, y = (tp.to_tensor(a) for a in _mlp_batch(0))
    lazy.set_lazy_mode(True)
    for _ in range(2):
        loss = TF.cross_entropy(m(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
    step = tp.jit.compile_train_step(
        m, lambda mm, a, b: TF.cross_entropy(mm(a), b), opt)
    out = step(x, y)
    assert not lazy.is_lazy(out) and np.isfinite(float(out))


# -- the graph cache's bookkeeping ------------------------------------------------
def test_graph_cache_transitions():
    e = lazy._Entry()
    assert [e.action(True) for _ in range(2)] == ["eager", "capture"]
    e.graph = object()  # what a capture leaves
    assert [e.action(True) for _ in range(3)] == ["replay"] * 3
    cpu = lazy._Entry()
    assert [cpu.action(False) for _ in range(4)] == ["eager"] * 4
    bad = lazy._Entry()
    bad.action(True)
    bad.action(True)
    bad.failed = "RuntimeError: capture failed"
    assert bad.action(True) == "fallback" and bad.sights == 3


def test_evict_cold_keeps_the_most_recent():
    lazy.evict_cold(0)
    t = tp.to_tensor(np.ones(4, np.float32))
    lazy.set_lazy_mode(True)
    outs = []
    for k in range(5):
        outs.append(t * float(k + 2))  # a new signature each
        lazy.flush()
    assert len(lazy._flush_cache) == 5
    c0 = profiler.counters().get("hbm_cache_evicted", 0)
    assert lazy.evict_cold(2) == 3
    assert len(lazy._flush_cache) == 2
    assert profiler.counters().get("hbm_cache_evicted", 0) - c0 == 3
    assert lazy.graph_stats()["entries"] == 2


def test_pending_summary_has_the_reference_keys():
    lazy.set_lazy_mode(True)
    t = tp.to_tensor(np.ones(4, np.float32))
    u = t + 1.0
    got = lazy.pending_summary()
    jlazy.flush()
    want = jlazy.pending_summary()
    assert set(got) == set(want)
    assert got["pending_nodes"] >= 1 and got["tail_ops"][-1] == \
        "aten.add.Tensor"
    del u


def test_the_default_is_off():
    """The reference's engine is on by default; the port's is off (ROADMAP
    §C), on every thread."""
    assert lazy._DEFAULT_ENABLED is False and jlazy._DEFAULT_ENABLED is True
    seen = []
    th = threading.Thread(target=lambda: seen.append(lazy.lazy_enabled()))
    th.start()
    th.join()
    assert seen == [False]
    t = tp.to_tensor(np.ones(2, np.float32))
    assert not lazy.is_lazy(t * 2.0)


def test_chunked_updates_equal_one_chunk(monkeypatch):
    """Adam's tail and the scheduled SGD step run by chunks of parameters
    (their temporaries stay small): the chunks give the one-chunk bits."""
    from paddle_tpu_torch import optimizer as topt

    runs = []
    for chunk in (topt._CHUNK_BYTES, 64):
        monkeypatch.setattr(topt, "_CHUNK_BYTES", chunk)
        for cls in ("AdamW", "SGD"):
            tm = _port_mlp(_ref_mlp())
            sched = tp.optimizer.lr.CosineAnnealingDecay(0.01, T_max=4)
            opt = getattr(tp.optimizer, cls)(learning_rate=sched,
                                             parameters=tm.parameters())
            for i in range(3):
                x, y = (tp.to_tensor(a) for a in _mlp_batch(i))
                TF.cross_entropy(tm(x), y).backward()
                opt.step()
                opt.clear_grad()
                sched.step()
            runs.append(_params(tm))
    for a, b in zip(runs[:2], runs[2:]):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
