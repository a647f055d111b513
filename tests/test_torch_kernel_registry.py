"""The port's kernel registry (``paddle_tpu_torch/ops/kernels``: registry,
autotune, db, builtin; ``paddle_tpu_torch/cost_model``) against the
reference's (``paddle_tpu/ops/kernels``, ``paddle_tpu/cost_model``) and its
contract, the classes of ``tests/test_kernel_registry.py``:

- **inert when off** (the default): resolution is a dict probe returning the
  pinned defaults (the launches of the call sites before the registry);
  the autotuner, the verifier and the DB are never touched (monkeypatched
  to raise), no counter moves and the tune dir stays empty, and importing
  the package imports neither ``autotune`` nor ``db``;
- **the DB**: round trip; a truncated, a deleted and an out-of-space entry
  are structured rejects or silent misses, never a wrong config; an entry
  of another kernel build or device is never used;
- **the search** never does worse than the defaults (stub kernels with
  scripted sleeps), and a real search of the fused CE on the CPU persists a
  winner whose loss equals the 2048-row loss;
- **parity with the reference** on the same inputs: every ``*_key`` helper's
  tuple, the CPU cost estimates of ``fused_ce`` and ``tp_collective``, the
  candidates' visit order, the fused CE with ``block_rows=None``;
- **the port's own axes**: the int8 head's blocks and waves at Llama's head
  on the card's figures, and the paged kernel's split floor.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.cost_model import CostModel as RefCostModel
from paddle_tpu.ops import kernels as RK
from paddle_tpu.ops.fused_ce import fused_linear_cross_entropy as ref_fce
from paddle_tpu.ops.kernels import autotune as ref_autotune
from paddle_tpu_torch.cost_model import CostModel, int8_blocks
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import _build, autotune, db, registry
from paddle_tpu_torch.profiler import counters
from paddle_tpu_torch.serving import observe

ROOT = Path(__file__).resolve().parents[1]
NAMES = ["flash_attention", "fused_ce", "int8_matmul", "paged_attention"]
# what each call site launched before the registry existed; the inert-mode
# contract is that resolve_config returns exactly these
PINNED = {
    "flash_attention": {"block_q": 128, "block_k": 128},
    "fused_ce": {"block_rows": 2048},
    "paged_attention": {"split": 0},
    "int8_matmul": {"block_n": 384},
}


def _tune_counters():
    return {k: v for k, v in counters().items() if k.startswith("kernel_tune")}


@pytest.fixture
def tune_env(tmp_path, monkeypatch):
    """An isolated tune dir and fast search knobs; the in-process memo is
    cleared on both sides, and stub kernels registered by the test are
    removed after it."""
    monkeypatch.setitem(flags._FLAGS, "FLAGS_kernel_tune_dir", str(tmp_path))
    monkeypatch.setitem(flags._FLAGS, "FLAGS_kernel_tune_samples", 2)
    monkeypatch.setitem(flags._FLAGS, "FLAGS_kernel_tune_budget_s", 60.0)
    before = set(registry._REGISTRY)
    autotune.clear_cache()
    yield tmp_path
    autotune.clear_cache()
    for name in set(registry._REGISTRY) - before:
        del registry._REGISTRY[name]


def _stub(name, sleeps, wrong=()):
    """A stub kernel whose per-config time and output are scripted:
    ``sleeps[width]`` seconds a call; widths in ``wrong`` return another
    output (verify must reject it)."""

    def runner(key):
        def make(config):
            w = config["width"]

            def step():
                time.sleep(sleeps.get(w, 0.0))
                if w in wrong:
                    return torch.full((4,), 7.0)
                return torch.zeros(4)

            return step

        return make

    return registry.register_kernel(
        name, defaults={"width": 8}, space={"width": (8, 16, 32)},
        runner=runner)


def _fce_inputs(n, d, v, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d).astype(np.float32) * 0.5,
            rng.randn(v, d).astype(np.float32) * 0.5,
            rng.randint(0, v, (n,)).astype(np.int32))


class TestInertOff:
    def test_names_are_the_reference_four(self):
        assert K.kernel_names() == NAMES
        assert set(NAMES) <= set(RK.kernel_names())

    def test_defaults_are_the_pinned_configs(self):
        for name, want in PINNED.items():
            assert K.resolve_config(name, ()) == want
            assert dict(K.get_kernel(name).defaults) == want

    def test_resolve_returns_a_copy(self):
        cfg = K.resolve_config("fused_ce", ())
        cfg["block_rows"] = 1
        assert K.resolve_config("fused_ce", ()) == PINNED["fused_ce"]

    def test_launch_config_off_builds_no_key(self, tune_env, monkeypatch):
        """The call sites' per-launch form: with off, the spec's read-only
        defaults and no key built; with ondemand, the key and the DB."""
        def no_key(*a):  # pragma: no cover - must never run with off
            raise AssertionError("key built with autotune off")

        for name, want in PINNED.items():
            cfg = K.launch_config(name, no_key, 1, 2)
            assert cfg == want
            with pytest.raises(TypeError):
                cfg[next(iter(want))] = 0  # shared: read-only
        key = K.fused_ce_key(24, 8, 20, torch.float32)
        db.store("fused_ce", key, {"block_rows": 512}, 1.0, 2.0)
        monkeypatch.setitem(flags._FLAGS, "FLAGS_kernel_autotune", "ondemand")
        assert K.launch_config("fused_ce", K.fused_ce_key, 24, 8, 20,
                               torch.float32) == {"block_rows": 512}

    def test_off_never_touches_autotuner_or_db(self, tmp_path, monkeypatch):
        """With autotune off, a resolve of every registered kernel and the
        port's real call sites never reach the autotuner, the verifier or
        the DB, move no counter and write no file."""
        monkeypatch.setitem(flags._FLAGS, "FLAGS_kernel_tune_dir",
                            str(tmp_path))
        assert flags.flag("FLAGS_kernel_autotune") == "off"

        def boom(*a, **k):  # pragma: no cover - must never run
            raise AssertionError("autotune layer touched with autotune off")

        for mod, fn in ((autotune, "resolve"), (autotune, "search"),
                        (autotune, "verify"), (db, "lookup"), (db, "store")):
            monkeypatch.setattr(mod, fn, boom)
        before = _tune_counters()
        for name in K.kernel_names():
            cfg = K.resolve_config(name, ())
            assert isinstance(cfg, dict) and cfg

        from paddle_tpu_torch.ops.fused_ce import fused_linear_cross_entropy

        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.randn(8, 16).astype(np.float32))
        w = torch.from_numpy(rng.randn(33, 16).astype(np.float32))
        labels = torch.from_numpy(rng.randint(0, 33, (8,)))
        assert torch.isfinite(fused_linear_cross_entropy(x, w, labels))
        q = torch.from_numpy(rng.randn(2, 8, 4, 16).astype(np.float32))
        assert K.flash_attention_array(q, q, q, causal=True).shape == q.shape
        kpool = torch.from_numpy(rng.randn(16, 8, 2, 16).astype(np.float32))
        tables = torch.from_numpy(rng.randint(1, 16, (2, 2)).astype(np.int32))
        pos = torch.tensor([3, 9], dtype=torch.int32)
        qr = torch.from_numpy(rng.randn(2, 4, 16).astype(np.float32))
        assert K.paged_attention_rows(qr, kpool, kpool, tables, pos).shape \
            == (2, 64)
        qw = torch.from_numpy(rng.randint(-127, 127, (32, 16)).astype(np.int8))
        xr = torch.from_numpy(rng.randn(3, 16).astype(np.float32))
        assert K.int8_matmul(xr, qw, torch.tensor(2.0)).shape == (3, 32)

        assert _tune_counters() == before
        assert not os.path.exists(str(tmp_path)) or \
            os.listdir(str(tmp_path)) == []

    def test_import_and_off_call_sites_leave_autotune_and_db_unimported(self):
        code = (
            "import sys, numpy as np, torch\n"
            "import paddle_tpu_torch.ops.kernels as K\n"
            "from paddle_tpu_torch.ops.fused_ce import "
            "fused_linear_cross_entropy as f\n"
            "x = torch.randn(8, 16); w = torch.randn(33, 16)\n"
            "f(x, w, torch.randint(0, 33, (8,)))\n"
            "[K.resolve_config(n, ()) for n in K.kernel_names()]\n"
            "bad = [m for m in sys.modules if m.endswith(('kernels.autotune',"
            " 'kernels.db', 'paddle_tpu_torch.cost_model'))]\n"
            "assert not bad, bad\n")
        env = dict(os.environ, PYTHONPATH=str(ROOT),
                   FLAGS_kernel_autotune="off")
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr


class TestTuningDB:
    def test_store_lookup_roundtrip(self, tune_env):
        key = (64, 32, "float32")
        db.store("stub_rt", key, {"width": 16}, 1.0, 2.0)
        assert db.lookup("stub_rt", key) == {"width": 16}
        # a different key is a plain miss, no reject
        before = counters().get("kernel_tune_db_rejects", 0)
        assert db.lookup("stub_rt", (65, 32, "float32")) is None
        assert counters().get("kernel_tune_db_rejects", 0) == before

    def test_default_dir_is_the_ports_own(self, monkeypatch):
        monkeypatch.setitem(flags._FLAGS, "FLAGS_kernel_tune_dir", "")
        assert db.tune_dir() == os.path.join(
            os.path.expanduser("~"), ".cache", "paddle_tpu_torch", "tune")

    def test_truncated_entry_is_structured_reject(self, tune_env):
        key = (64, 32, "float32")
        path = db.store("stub_torn", key, {"width": 16}, 1.0, 2.0)
        with open(path) as f:
            raw = f.read()
        with open(path, "w") as f:
            f.write(raw[: len(raw) // 2])  # torn write
        before = counters().get("kernel_tune_db_rejects", 0)
        assert db.lookup("stub_torn", key) is None  # never a wrong config
        assert counters().get("kernel_tune_db_rejects", 0) == before + 1
        assert not os.path.exists(path)  # bad file removed

    def test_hand_edited_entry_is_structured_reject(self, tune_env):
        key = (64, 32, "float32")
        path = db.store("stub_edit", key, {"width": 16}, 1.0, 2.0)
        with open(path) as f:
            raw = f.read()
        with open(path, "w") as f:
            f.write(raw.replace('"width": 16', '"width": 32'))
        before = counters().get("kernel_tune_db_rejects", 0)
        assert db.lookup("stub_edit", key) is None
        assert counters().get("kernel_tune_db_rejects", 0) == before + 1

    def test_db_deleted_is_silent_default_fallback(self, tune_env,
                                                   monkeypatch):
        monkeypatch.setitem(flags._FLAGS, "FLAGS_kernel_autotune", "ondemand")
        spec = _stub("stub_deleted", sleeps={})
        assert autotune.resolve(spec, (1,), "ondemand") == {"width": 8}
        assert os.listdir(str(tune_env)) == []  # ondemand never searches

    def test_out_of_space_entry_rejected_not_launched(self, tune_env):
        spec = _stub("stub_oos", sleeps={})
        key = (2,)
        db.store("stub_oos", key, {"width": 999}, 1.0, 2.0)
        before = counters().get("kernel_tune_db_rejects", 0)
        assert autotune.resolve(spec, key, "ondemand") == {"width": 8}
        assert counters().get("kernel_tune_db_rejects", 0) == before + 1

    def test_entry_of_another_kernel_build_or_card_is_never_used(
            self, tune_env, monkeypatch):
        """The port keys an entry on the kernel source's digest (the one in
        the built library's name) and the device: an edited kernel or
        another card misses, and a stored entry names both."""
        key = K.paged_attention_key(32, 64, 16, 16, 1, 128, torch.bfloat16)
        path = db.store("paged_attention", key, {"split": 4}, 1.0, 2.0)
        assert db.lookup("paged_attention", key) == {"split": 4}
        entry = db._body("paged_attention", key)
        assert entry["source"] == _build.source_digest("paged_attention")
        assert entry["device"] == "cpu" and entry["torch"] == torch.__version__
        assert os.path.basename(path).startswith("paged_attention-")
        real = _build.source_digest
        monkeypatch.setattr(_build, "source_digest",
                            lambda name: "0" * 12 if name == "paged_attention"
                            else real(name))
        assert db.lookup("paged_attention", key) is None
        monkeypatch.setattr(_build, "source_digest", real)
        monkeypatch.setattr(db, "_device", lambda: {"device": "NVIDIA H100",
                                                    "capability": "9.0"})
        assert db.lookup("paged_attention", key) is None


class TestSearch:
    def test_winner_is_fastest_verified_and_persists(self, tune_env):
        # width 16 is fastest and correct; 32 is slower than the default
        spec = _stub("stub_win", sleeps={8: 0.02, 16: 0.0, 32: 0.05})
        key = (64, "float32")
        c0 = dict(counters())
        assert autotune.resolve(spec, key, "search") == {"width": 16}
        c1 = dict(counters())
        assert c1.get("kernel_tune_searches", 0) == \
            c0.get("kernel_tune_searches", 0) + 1
        assert c1.get("kernel_tune_candidates", 0) == \
            c0.get("kernel_tune_candidates", 0) + 2
        assert os.path.exists(db.entry_path("stub_win", key))
        # a fresh process (memo cleared) resolves from disk: no search, a hit
        autotune.clear_cache()
        assert autotune.resolve(spec, key, "search") == {"width": 16}
        c2 = dict(counters())
        assert c2.get("kernel_tune_searches", 0) == \
            c1.get("kernel_tune_searches", 0)
        assert c2.get("kernel_tune_hits", 0) == \
            c1.get("kernel_tune_hits", 0) + 1

    def test_wrong_output_candidate_never_wins(self, tune_env):
        # width 16 would be fastest but gives another output; 32 is slower
        # than the default, so the defaults win
        spec = _stub("stub_wrong", sleeps={8: 0.02, 16: 0.0, 32: 0.05},
                     wrong=(16,))
        c0 = counters().get("kernel_tune_verify_fails", 0)
        assert autotune.resolve(spec, (3,), "search") == {"width": 8}
        assert counters().get("kernel_tune_verify_fails", 0) == c0 + 1

    def test_corrupt_db_entry_triggers_retune(self, tune_env):
        spec = _stub("stub_corrupt", sleeps={8: 0.01, 16: 0.0, 32: 0.05})
        key = (4,)
        autotune.resolve(spec, key, "search")
        with open(db.entry_path("stub_corrupt", key), "w") as f:
            f.write("{")  # torn
        autotune.clear_cache()
        c0 = dict(counters())
        assert autotune.resolve(spec, key, "search") == {"width": 16}
        c1 = dict(counters())
        assert c1.get("kernel_tune_db_rejects", 0) == \
            c0.get("kernel_tune_db_rejects", 0) + 1
        assert c1.get("kernel_tune_searches", 0) == \
            c0.get("kernel_tune_searches", 0) + 1

    def test_broken_runner_degrades_to_defaults(self, tune_env):
        def runner(key):
            def make(config):
                raise RuntimeError("no backend")

            return make

        spec = registry.register_kernel(
            "stub_broken", defaults={"width": 8}, space={"width": (8, 16)},
            runner=runner)
        assert autotune.resolve(spec, (5,), "search") == {"width": 8}
        # nothing was measured, so nothing may persist
        assert not os.path.exists(db.entry_path("stub_broken", (5,)))

    def test_search_records_the_kernel_estimate_drift(self, tune_env):
        observe.reset()
        spec = _stub("stub_drift", sleeps={8: 0.01, 16: 0.0, 32: 0.03})
        autotune.resolve(spec, (6,), "search")
        # a stub's estimates all tie (0.0), so no pair is ordered: no sample
        assert "kernel_estimate" not in observe.drift_gauges()
        autotune.search(K.get_kernel("fused_ce"), K.fused_ce_key(
            64, 8, 24, torch.float32))
        g = observe.drift_gauges()["kernel_estimate"]
        assert g["samples"] == 1 and 0.0 <= g["last_rel_err"] <= 1.0
        assert g["measured"] == 5 and g["pairs"] >= 1

    def test_verify_flattens_and_holds_dtype_tolerance(self):
        a = torch.ones(4, dtype=torch.bfloat16)
        assert autotune.verify((a, [a * 2]), (a, [a * 2]))
        assert autotune.verify(a * 1.01, a)  # within 2e-2 in bf16
        assert not autotune.verify(a * 1.05, a)
        assert not autotune.verify(a.float() * (1 + 1e-4), a.float())
        assert not autotune.verify(a, a.float())  # dtype differs
        assert not autotune.verify((a,), (a, a))
        inf = torch.tensor([1.0, float("inf")])
        assert not autotune.verify(torch.tensor([1.0, 2.0]), inf)

    def test_real_fused_ce_search_on_cpu_persists_a_winner(self, tune_env,
                                                           monkeypatch):
        from paddle_tpu_torch.ops.fused_ce import fused_linear_cross_entropy

        x, w, labels = (torch.from_numpy(a) for a in _fce_inputs(600, 16, 40))
        key = K.fused_ce_key(600, 16, 40, torch.float32)
        assert key == (1024, 16, 40, "float32")
        monkeypatch.setitem(flags._FLAGS, "FLAGS_kernel_autotune", "search")
        c0 = dict(counters())
        loss = fused_linear_cross_entropy(x, w, labels)
        c1 = dict(counters())
        assert c1.get("kernel_tune_searches", 0) == \
            c0.get("kernel_tune_searches", 0) + 1
        assert c1.get("kernel_tune_candidates", 0) == \
            c0.get("kernel_tune_candidates", 0) + 4
        for k in ("kernel_tune_candidate_errors", "kernel_tune_verify_fails"):
            assert c1.get(k, 0) == c0.get(k, 0)
        assert os.path.exists(db.entry_path("fused_ce", key))
        winner = db.lookup("fused_ce", key)
        assert winner["block_rows"] in (512, 1024, 2048, 4096, 8192)
        # a fresh process resolves it from disk with no search
        autotune.clear_cache()
        monkeypatch.setitem(flags._FLAGS, "FLAGS_kernel_autotune", "ondemand")
        assert K.resolve_config("fused_ce", key) == winner
        c2 = dict(counters())
        assert c2.get("kernel_tune_hits", 0) == c1.get("kernel_tune_hits", 0) + 1
        assert c2.get("kernel_tune_searches", 0) == \
            c1.get("kernel_tune_searches", 0)
        pinned = fused_linear_cross_entropy(x, w, labels, block_rows=2048)
        assert abs(float(loss) - float(pinned)) <= 1e-6


class TestParityWithReference:
    @pytest.mark.parametrize("args", [(32, 64, 16, 16, 1, 128),
                                      (1, 128, 16, 32, 1, 128),
                                      (4, 8, 8, 2, 4, 64)])
    @pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
    def test_paged_attention_key(self, args, dtype):
        assert K.paged_attention_key(*args, getattr(torch, dtype)) == \
            RK.paged_attention_key(*args, getattr(jnp, dtype))

    @pytest.mark.parametrize("args", [(1, 4096, 32000, False),
                                      (32, 2048, 50304, True),
                                      (5, 2048, 50304, True),
                                      (160, 1000, 50257, False)])
    @pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
    def test_int8_matmul_key(self, args, dtype):
        assert K.int8_matmul_key(*args, getattr(torch, dtype)) == \
            RK.int8_matmul_key(*args, getattr(jnp, dtype))

    @pytest.mark.parametrize("args", [(2, 16, 2048, 2048, 128, True),
                                      (3, 5, 100, 77, 40, False),
                                      (1, 16, 8192, 8192, 64, True)])
    @pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
    def test_flash_attention_key(self, args, dtype):
        b, h, t, tk, d, causal = args
        assert K.flash_attention_key(b, h, t, tk, d, getattr(torch, dtype),
                                     causal) == \
            RK.flash_attention_key(b, h, t, tk, d, getattr(jnp, dtype),
                                   causal)

    @pytest.mark.parametrize("args", [(4096, 2048, 50304), (600, 16, 40),
                                      (1, 8, 8), (1000, 512, 50000)])
    @pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
    def test_fused_ce_key(self, args, dtype):
        assert K.fused_ce_key(*args, getattr(torch, dtype)) == \
            RK.fused_ce_key(*args, getattr(jnp, dtype))

    @pytest.mark.parametrize("key", [(4096, 2048, 50304, "bfloat16"),
                                     (1000, 512, 50000, "float32"),
                                     (1024, 16, 40, "float32")])
    def test_fused_ce_estimate_on_cpu(self, key):
        cm, ref = CostModel("cpu"), RefCostModel()
        for br in K.get_kernel("fused_ce").space["block_rows"]:
            cfg = {"block_rows": br}
            assert cm.kernel_estimate("fused_ce", key, cfg) == \
                ref.kernel_estimate("fused_ce", key, cfg)

    @pytest.mark.parametrize("key", [(0, 1), (1 << 20, 2), (12345678, 4),
                                     (3.5e9, 8)])
    def test_tp_collective_estimate_on_cpu(self, key):
        assert CostModel("cpu").kernel_estimate("tp_collective", key, {}) == \
            RefCostModel().kernel_estimate("tp_collective", key, {})

    @pytest.mark.parametrize("key", [(1000, 512, 50000, "float32"),
                                     (4096, 2048, 50304, "bfloat16")])
    def test_fused_ce_candidates_in_reference_order(self, key, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        got = autotune.candidates(K.get_kernel("fused_ce"), key)
        want = ref_autotune.candidates(RK.get_kernel("fused_ce"), key)
        assert got == want and len(got) == 4

    def test_fused_ce_with_registry_block_equals_reference(self):
        x, w, labels = _fce_inputs(37, 16, 50, seed=3)
        got = K.resolve_config("fused_ce", K.fused_ce_key(37, 16, 50,
                                                          torch.float32))
        assert got == {"block_rows": 2048}
        from paddle_tpu_torch.ops.fused_ce import fused_linear_cross_entropy

        port = fused_linear_cross_entropy(*(torch.from_numpy(a)
                                            for a in (x, w, labels)))
        ref = ref_fce(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels))
        np.testing.assert_allclose(float(port), float(ref), rtol=1e-5,
                                   atol=1e-5)

    def test_nn_functional_fused_ce_resolves_too(self, tune_env, monkeypatch):
        from paddle_tpu_torch.nn import functional as F

        x, w, labels = (torch.from_numpy(a) for a in _fce_inputs(24, 8, 20))
        key = K.fused_ce_key(24, 8, 20, torch.float32)
        db.store("fused_ce", key, {"block_rows": 512}, 1.0, 2.0)
        monkeypatch.setitem(flags._FLAGS, "FLAGS_kernel_autotune", "ondemand")
        h0 = counters().get("kernel_tune_hits", 0)
        loss = F.fused_linear_cross_entropy(x.reshape(2, 12, 8), w,
                                            labels.reshape(2, 12))
        assert counters().get("kernel_tune_hits", 0) == h0 + 1
        pinned = F.fused_linear_cross_entropy(x, w, labels, block_rows=2048)
        assert abs(float(loss) - float(pinned)) <= 1e-6


class TestPortAxes:
    def test_int8_blocks_and_waves_at_llamas_head(self):
        """At Llama-7B's head (K = 4096, N = 32000) 384 rows a block give 84
        blocks in one wave on 132 SMs; 192 give 167 in two (one block an SM
        either way: 226 and 130 KB of shared memory)."""
        key = K.int8_matmul_key(1, 4096, 32000, False, torch.bfloat16)
        assert int8_blocks(32000, 384) == (84, 1, 1)
        assert int8_blocks(32000, 192) == (167, 1, 2)
        cm = CostModel("cuda")
        est = {bn: cm.kernel_estimate("int8_matmul", key, {"block_n": bn})
               for bn in (384, 192)}
        assert est[384] == pytest.approx(0.06824059637263631, rel=1e-12)
        assert est[192] == pytest.approx(0.06924059637263631, rel=1e-12)
        # GPT's head: 131 blocks of 384, one wave; 262 of 192, two
        assert int8_blocks(50304, 384) == (131, 1, 1)
        assert int8_blocks(50304, 192) == (262, 1, 2)

    def test_int8_f32_key_has_no_candidate(self):
        spec = K.get_kernel("int8_matmul")
        assert autotune.candidates(spec, K.int8_matmul_key(
            1, 64, 64, True, torch.float32)) == []
        assert autotune.candidates(spec, K.int8_matmul_key(
            1, 4096, 32000, False, torch.bfloat16)) == [{"block_n": 192}]

    @pytest.mark.parametrize("MB,BS,valid", [
        (64, 16, (0, 1, 2, 4, 8)),  # 1024 positions: 128 a block at 8
        (4, 16, (0, 1)),            # 64 positions: split 2 leaves 32 a block
        (8, 16, (0, 1, 2)),         # 128: 64 a block at 2, 32 at 4
        (1, 16, (0, 1)),
        (128, 16, (0, 1, 2, 4, 8)),
    ])
    def test_paged_split_below_64_positions_a_block_is_invalid(self, MB, BS,
                                                               valid):
        spec = K.get_kernel("paged_attention")
        key = K.paged_attention_key(32, MB, BS, 16, 1, 128, torch.bfloat16)
        got = tuple(s for s in spec.space["split"]
                    if spec.valid({"split": s}, key))
        assert got == valid
        assert sorted(c["split"] for c in autotune.candidates(spec, key)) \
            == [s for s in valid if s], "every valid non-default split"

    def test_paged_estimate_rule_split_is_the_kernels(self):
        from paddle_tpu_torch.cost_model import paged_split_rule

        import chip_smoke

        cm = CostModel("cuda")
        for B, KV, MB in ((32, 16, 64), (2, 16, 128), (1, 32, 4),
                          (8, 16, 8), (32, 32, 64)):
            rule = paged_split_rule(B, KV, 16, MB)
            assert rule == chip_smoke.paged_split_rule(B, KV, 16, MB, 132)
            key = (B, MB, 16, KV, 1, 128, "bfloat16")
            assert cm.kernel_estimate("paged_attention", key, {"split": 0}) \
                == cm.kernel_estimate("paged_attention", key, {"split": rule})

    def test_profile_measure_counts_flops_and_time(self):
        a, b = torch.randn(16, 32), torch.randn(32, 8)
        out = CostModel("cpu").profile_measure(fn=torch.matmul, args=(a, b),
                                               iters=3)
        assert out["flops"] == 2 * 16 * 32 * 8 and out["time"] > 0
        with pytest.raises(ValueError):
            CostModel("cpu").profile_measure()

    def test_unknown_kernel_scores_zero(self):
        assert CostModel("cuda").kernel_estimate("no_such", (), {}) == 0.0
        assert CostModel("cpu").kernel_estimate("no_such", (), {}) == 0.0
