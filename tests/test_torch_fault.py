"""Port parity: ``paddle_tpu_torch.fault`` against ``paddle_tpu.fault``.

The spec grammar and the firing decisions of ``inject`` must equal the
reference's on the same specs and the same call sequences (both modules are
armed with one spec, driven with the same calls, and disarmed after). The
memory classifier takes ``torch.OutOfMemoryError`` (which
``torch.cuda.OutOfMemoryError`` names), the synthesized ``hbm.oom`` error
and either one wrapped as a ``__cause__`` or ``__context__``; a plain
``RuntimeError`` without the reference's status markers is not an
out-of-memory.
"""
import pytest
import torch

from paddle_tpu.fault import inject as jinject
from paddle_tpu_torch import profiler
from paddle_tpu_torch.fault import inject, memory

SPECS = [
    "serve.crash:at=3",
    "serve.slow_step:at=1,ms=500;serve.crash:step=24",
    "serve.wedge:from=2,ms=100,times=2",
    "hbm.oom:op=serve.step,at=8",
    "hbm.oom:op=serve.step,call=2,times=1;hbm.pressure:blocks=4,bytes=64",
    "serve.snapshot_corrupt",
    " serve.pool_corrupt : step=5 ; ",
]


@pytest.fixture(autouse=True)
def _disarm():
    yield
    inject.disarm()
    jinject.disarm()


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_reference(spec):
    assert inject._parse_spec(spec) == jinject._parse_spec(spec)


# each call: (point, step, op); steps and ops interleave so that the op
# filter, the step match and the counts all matter
CALLS = ([("serve.crash", i, None) for i in range(6)]
         + [("serve.slow_step", i, None) for i in range(4)]
         + [("hbm.oom", i, op) for i in range(12)
            for op in ("serve.step", "lazy_flush")]
         + [("serve.wedge", i, None) for i in range(5)]
         + [("serve.crash", 24, None), ("serve.pool_corrupt", 5, None),
            ("serve.snapshot_corrupt", None, None)] * 2)


@pytest.mark.parametrize("spec", SPECS)
def test_should_fire_counts_match_reference(spec):
    inject.arm(spec)
    jinject.arm(spec)
    got = [inject.should_fire(p, step=s, op=o) for p, s, o in CALLS]
    want = [jinject.should_fire(p, step=s, op=o) for p, s, o in CALLS]
    assert got == want
    assert inject.fired_counts() == jinject.fired_counts()
    assert any(got)
    for point in inject._parse_spec(spec):
        assert inject.point_cfg(point) == jinject.point_cfg(point)
    assert inject.armed() and jinject.armed()
    assert inject.pressure_bytes() == jinject.pressure_bytes()


def test_unknown_point_and_disarm():
    with pytest.raises(KeyError, match="did you mean 'serve.crash'"):
        inject.arm("serve.crsh:at=1")
    inject.arm("serve.crash:from=1")
    assert inject.should_fire("serve.crash", step=0)
    inject.disarm()
    assert not inject.armed() and not inject.should_fire("serve.crash")
    assert inject.fired_counts() == {}
    assert "serve.crash" in inject.exercised()
    with pytest.raises(KeyError):
        inject.should_fire("no.such.point")
    # the distributed points are registered since the checkpoint's port
    assert not inject.should_fire("ckpt.write")


def test_check_raises_injected_fault():
    inject.arm("serve.pool_corrupt:at=2")
    inject.check("serve.pool_corrupt")
    with pytest.raises(inject.InjectedFault) as ei:
        inject.check("serve.pool_corrupt", step=7)
    assert isinstance(ei.value, OSError) and ei.value.ctx == {"step": 7}


def test_maybe_hbm_oom_raises_torch_oom_at_its_site():
    inject.arm("hbm.oom:op=serve.step,at=2")
    inject.maybe_hbm_oom("lazy_flush")  # another site: not counted
    inject.maybe_hbm_oom("serve.step")
    with pytest.raises(torch.OutOfMemoryError, match="RESOURCE_EXHAUSTED"):
        inject.maybe_hbm_oom("serve.step")


def _wrapped(inner, how):
    try:
        try:
            raise inner
        except Exception as e:
            if how == "cause":
                raise RuntimeError("step failed") from e
            raise RuntimeError("step failed")
    except RuntimeError as outer:
        return outer


@pytest.mark.parametrize("make", [
    lambda: torch.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
    lambda: torch.cuda.OutOfMemoryError("no text at all"),
    lambda: inject.hbm_oom_error("serve.step"),
    lambda: MemoryError(),
    lambda: RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying"),
], ids=["torch_oom", "cuda_oom_no_text", "hbm_oom_error", "memory_error",
        "marker_text"])
@pytest.mark.parametrize("how", ["bare", "cause", "context"])
def test_is_oom_true(make, how):
    e = make() if how == "bare" else _wrapped(make(), how)
    assert memory.is_oom(e)
    assert memory.classify(e)["kind"] == "hbm_oom"


@pytest.mark.parametrize("err", [
    RuntimeError("shape mismatch"), ValueError("bad"),
    OSError("Failed to allocate inode"),
], ids=["runtime", "value", "weak_marker_only"])
def test_is_oom_false(err):
    assert not memory.is_oom(err) and memory.classify(err) is None
    assert not memory.is_oom(_wrapped(err, "cause"))


def test_note_oom_counts_and_records():
    c0 = profiler.counters().get("hbm_oom_trips", 0)
    info = memory.note_oom("serve.step", inject.hbm_oom_error("serve.step"))
    assert info["where"] == "serve.step" and info["type"] == "OutOfMemoryError"
    assert profiler.counters()["hbm_oom_trips"] == c0 + 1
    assert memory.recent_ooms()[-1]["where"] == "serve.step"


def test_pressure_handler_registry_is_weak():
    class Owner:
        def shrink(self):
            return {"parked": 3}

    owner = Owner()
    memory.register_pressure_handler("t_owner", lambda o: o.shrink(),
                                     owner=owner)
    memory.register_pressure_handler("t_plain", lambda: {"ok": 1})
    try:
        got = memory.free_pressure("test")["handlers"]
        assert got["t_owner"] == {"parked": 3} and got["t_plain"] == {"ok": 1}
        del owner
        assert "t_owner" not in memory.free_pressure("test")["handlers"]
    finally:
        memory.unregister_pressure_handler("t_plain")
        memory.unregister_pressure_handler("t_owner")
    assert "t_plain" not in memory.free_pressure("test")["handlers"]
