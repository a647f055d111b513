"""The port's v1 data modules against the reference's: the ``dataset``
generators, ``dataset.common``, the ``reader`` decorators and ``batch``,
and the v1 training loop (dataset -> reader -> batch -> train)."""
import random

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import dataset as jdataset
from paddle_tpu import reader as jreader

import paddle_tpu_torch as tp
from paddle_tpu_torch import dataset as pdataset
from paddle_tpu_torch import reader as preader
from torch_port_util import cpu_device

GENERATORS = ["mnist", "cifar", "imdb", "imikolov", "uci_housing",
              "movielens", "conll05", "wmt14", "wmt16"]


def _flat(sample):
    if isinstance(sample, (tuple, list)):
        return [a for s in sample for a in _flat(s)]
    return [sample]


def _same(got, want):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g) is type(w) or (isinstance(g, np.generic)
                                      and isinstance(w, np.generic))
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("name", GENERATORS)
def test_generators_first_samples_equal(name, mode, monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    want = getattr(getattr(jdataset, name), mode)()()
    got = getattr(getattr(pdataset, name), mode)()()
    for _ in range(3):
        _same(next(got), next(want))


def test_common_md5_download_and_home(tmp_path):
    from paddle_tpu.dataset import common as jcommon
    from paddle_tpu_torch.dataset import common

    f = tmp_path / "blob"
    f.write_bytes(np.random.RandomState(0).bytes(3 << 20))
    assert common.md5file(str(f)) == jcommon.md5file(str(f))
    assert isinstance(common.DATA_HOME, str) and common.DATA_HOME
    with pytest.raises(RuntimeError, match="egress"):
        common.download("http://x", "m", "0")
    assert sorted(pdataset.__all__) == sorted(jdataset.__all__)


def _both(fn):
    """``fn(reader_module)`` in each package: (port's, reference's)."""
    return fn(preader), fn(jreader)


def _r(n):
    return lambda: iter(range(n))


@pytest.mark.parametrize("case", [
    "cache", "map_readers", "chain", "compose", "compose_unchecked",
    "firstn", "buffered", "xmap_ordered", "xmap_unordered", "batch",
    "batch_drop_last"])
def test_combinators_equal_the_reference(case):
    def run(R):
        if case == "cache":
            calls = []

            def creator():
                calls.append(1)
                return iter(range(5))

            c = R.cache(creator)
            return [list(c()), list(c()), len(calls)]
        if case == "map_readers":
            return list(R.map_readers(lambda a, b: a * 10 + b, _r(4),
                                      lambda: iter([7, 8, 9, 6]))())
        if case == "chain":
            return list(R.chain(_r(2), lambda: iter([5, 6]), _r(1))())
        if case == "compose":
            return list(R.compose(_r(3), lambda: iter([(1, 2), (3, 4),
                                                       (5, 6)]))())
        if case == "compose_unchecked":
            return list(R.compose(_r(2), _r(5), check_alignment=False)())
        if case == "firstn":
            return list(R.firstn(_r(100), 7)())
        if case == "buffered":
            return list(R.buffered(_r(50), 3)())
        if case == "xmap_ordered":
            return list(R.xmap_readers(lambda x: x * x + 1, _r(40), 4, 8,
                                       order=True)())
        if case == "xmap_unordered":
            return sorted(R.xmap_readers(lambda x: -x, _r(40), 3, 5)())
        mod = tp if R is preader else paddle_tpu
        return list(mod.batch(_r(10), 4, drop_last=case.endswith("last"))())

    got, want = _both(run)
    assert got == want


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("buf", [1, 4, 64])
def test_shuffle_under_the_same_random_seed(seed, buf):
    out = []
    for R in (preader, jreader):
        random.seed(seed)
        out.append(list(R.shuffle(_r(37), buf)()))
    assert out[0] == out[1] and sorted(out[0]) == list(range(37))


def test_errors_equal_the_reference():
    for R in (preader, jreader):
        with pytest.raises(R.ComposeNotAligned):
            list(R.compose(_r(1), _r(2))())

        def bad():
            yield 1
            raise KeyError("boom")

        with pytest.raises(KeyError):
            list(R.buffered(bad, 2)())
        with pytest.raises(ZeroDivisionError):
            list(R.xmap_readers(lambda x: 1 // x, _r(4), 2, 2)())
        c = R.cache(bad)
        with pytest.raises(KeyError):
            list(c())
        with pytest.raises(KeyError):  # a failed pass commits nothing
            list(c())
    for mod in (tp, paddle_tpu):
        with pytest.raises(ValueError):
            mod.batch(_r(1), 0)


def test_v1_training_loop_equals_the_reference():
    """dataset -> reader.firstn -> batch -> train, the reference's v1 loop
    (``tests/test_v1_namespaces.py``) in both packages from one start."""
    import paddle_tpu.nn as jnn

    paddle_tpu.seed(0)
    jm = jnn.Linear(13, 1)
    jopt = paddle_tpu.optimizer.SGD(learning_rate=0.01,
                                    parameters=jm.parameters())
    with cpu_device():
        pm = tp.nn.Linear(13, 1)
        pm.set_state_dict({k: torch.from_numpy(np.array(v.numpy()))
                           for k, v in jm.state_dict().items()})
        popt = tp.optimizer.SGD(learning_rate=0.01,
                                parameters=pm.parameters())
        losses = {"port": [], "ref": []}
        for pb, jb in zip(
                tp.batch(preader.firstn(pdataset.uci_housing.train(), 64),
                         16)(),
                paddle_tpu.batch(jreader.firstn(jdataset.uci_housing.train(),
                                                64), 16)()):
            x = np.stack([np.asarray(f, np.float32).reshape(-1)
                          for f, _ in pb])
            y = np.asarray([t for _, t in pb], np.float32).reshape(-1, 1)
            loss = ((pm(tp.to_tensor(x)) - tp.to_tensor(y)) ** 2).mean()
            loss.backward()
            popt.step()
            popt.clear_grad()
            losses["port"].append(float(loss.item()))
            jx = np.stack([np.asarray(f, np.float32).reshape(-1)
                           for f, _ in jb])
            jy = np.asarray([t for _, t in jb], np.float32).reshape(-1, 1)
            jl = ((jm(paddle_tpu.to_tensor(jx)) - paddle_tpu.to_tensor(jy))
                  ** 2).mean()
            jl.backward()
            jopt.step()
            jopt.clear_grad()
            losses["ref"].append(float(jl.item()))
            np.testing.assert_array_equal(x, jx)
    assert len(losses["port"]) == 4 and np.isfinite(losses["port"]).all()
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-5)
    np.testing.assert_allclose(pm.weight.detach().numpy(),
                               np.asarray(jm.weight.numpy()), rtol=1e-5,
                               atol=1e-6)
