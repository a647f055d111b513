"""``vision.transforms`` and ``vision.datasets`` against the reference's,
on the same numpy images:

- the deterministic transforms (``ToTensor``, ``Normalize``, ``Resize``,
  the crops, flips and ``Transpose``, and the functional forms) exactly,
  or within rtol 1e-5, atol 1e-5 for ``Resize`` (the reference's
  ``jax.image.resize`` weights are float32, the port's float64 then cast);
- the random ones after the same ``np.random.seed`` exactly (both draw from
  numpy's global generator), and with a ``torch.Generator`` by shape and
  range;
- the datasets: the synthetic arrays (``PADDLE_TPU_SYNTH_N`` small) and the
  files they read (tiny gzip idx files for MNIST, ``.npy`` trees for the
  folder datasets, written here) exactly, under a temporary
  ``PADDLE_TPU_DATA_HOME``.
"""
import gzip
import struct

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.vision.datasets as RD
import paddle_tpu.vision.transforms as RT
import paddle_tpu_torch as tp
import paddle_tpu_torch.vision.datasets as PD
import paddle_tpu_torch.vision.transforms as PT
from torch_port_util import cpu_device

RNG = np.random.RandomState(0)
HWC = (RNG.rand(12, 10, 3) * 255).astype(np.float32)
GRAY = (RNG.rand(9, 7) * 255).astype(np.float32)
CHW = RNG.rand(3, 11, 9).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


@pytest.mark.parametrize("img", [HWC, GRAY, HWC / 255.0],
                         ids=["hwc", "gray", "unit"])
@pytest.mark.parametrize("fmt", ["CHW", "HWC"])
def test_to_tensor(img, fmt):
    got = PT.ToTensor(fmt)(img)
    want = RT.ToTensor(fmt)(img)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_array_equal(PT.to_tensor(img, fmt).numpy(), got)


def test_normalize_numpy_and_tensor():
    mean, std = [0.5, 0.4, 0.3], [0.2, 0.25, 0.3]
    np.testing.assert_array_equal(PT.Normalize(mean, std)(CHW),
                                  RT.Normalize(mean, std)(CHW))
    hwc = CHW.transpose(1, 2, 0).copy()
    np.testing.assert_array_equal(
        PT.normalize(hwc, mean, std, data_format="HWC"),
        RT.normalize(hwc, mean, std, data_format="HWC"))
    got = PT.Normalize(mean, std)(torch.from_numpy(CHW))
    want = RT.Normalize(mean, std)(paddle.to_tensor(CHW))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("img", [HWC, GRAY, CHW], ids=["hwc", "gray", "chw"])
@pytest.mark.parametrize("size", [5, (16, 7), (24, 20)])
def test_resize_is_the_references(img, size):
    got = PT.Resize(size)(img)
    want = RT.Resize(size)(img)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(PT.resize(img, size), got)


def test_crops_flips_transpose_compose():
    for size in (4, (5, 3), (20, 20)):
        np.testing.assert_array_equal(PT.CenterCrop(size)(HWC),
                                      RT.CenterCrop(size)(HWC))
        np.testing.assert_array_equal(PT.center_crop(HWC, size),
                                      RT.center_crop(HWC, size))
    np.testing.assert_array_equal(PT.hflip(HWC), RT.hflip(HWC))
    np.testing.assert_array_equal(PT.vflip(HWC), RT.vflip(HWC))
    for img in (HWC, GRAY):
        np.testing.assert_array_equal(PT.Transpose()(img),
                                      RT.Transpose()(img))
    pipe = [PT.CenterCrop(8), PT.Resize(6), PT.ToTensor(),
            PT.Normalize([0.5] * 3, [0.5] * 3)]
    rpipe = [RT.CenterCrop(8), RT.Resize(6), RT.ToTensor(),
             RT.Normalize([0.5] * 3, [0.5] * 3)]
    got, want = PT.Compose(pipe)(HWC), RT.Compose(rpipe)(HWC)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,args", [
    ("RandomCrop", (6,)), ("RandomCrop", ((5, 4), 2)),
    ("RandomHorizontalFlip", ()), ("RandomVerticalFlip", ()),
    ("BrightnessTransform", (0.4,))])
def test_random_transforms_draw_as_the_reference(name, args):
    got, want = [], []
    np.random.seed(11)
    t = getattr(PT, name)(*args)
    got = [t(HWC) for _ in range(6)]
    np.random.seed(11)
    r = getattr(RT, name)(*args)
    want = [r(HWC) for _ in range(6)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # with one of the port's generators: held by shape and range
    gen = torch.Generator().manual_seed(3)
    t = getattr(PT, name)(*args, generator=gen)
    outs = [t(HWC) for _ in range(8)]
    for o in outs:
        assert o.shape == want[0].shape
        assert 0.0 <= o.min() and o.max() <= 255.0
    if name != "BrightnessTransform":
        assert all(np.isin(o, HWC).all() or o.min() == 0 for o in outs)
    if name.endswith("Flip"):
        assert len({o.tobytes() for o in outs}) == 2  # both outcomes seen


# -- datasets -----------------------------------------------------------------
@pytest.fixture
def data_home(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_SYNTH_N", "40")
    return tmp_path


def test_data_home_reads_the_references_variable(data_home, monkeypatch):
    from paddle_tpu.io import data_home as ref_home

    assert tp.io.data_home() == ref_home() == str(data_home)
    monkeypatch.delenv("PADDLE_TPU_DATA_HOME")
    # without it, each package has its own cache directory
    assert tp.io.data_home().endswith("paddle_tpu_torch/datasets")


def _same_dataset(got, want, n=None):
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert len(got) == len(want)
    for i in range(n or len(want)):
        (gi, gl), (wi, wl) = got[i], want[i]
        np.testing.assert_array_equal(_np(gi), _np(wi))
        assert int(gl) == int(wl) and np.asarray(gl).dtype == np.int64


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST", "Cifar10",
                                 "Cifar100"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_synthetic_datasets_are_the_references(data_home, cls, mode):
    got, want = getattr(PD, cls)(mode=mode), getattr(RD, cls)(mode=mode)
    assert len(got) == 40
    _same_dataset(got, want, n=3)


def _idx(path, arr, magic):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", magic) + b"".join(
            struct.pack(">I", d) for d in arr.shape) + arr.tobytes())


def test_mnist_reads_the_idx_files(data_home):
    rng = np.random.RandomState(4)
    (data_home / "mnist").mkdir()
    for prefix, n in (("train", 7), ("t10k", 5)):
        _idx(data_home / "mnist" / f"{prefix}-images-idx3-ubyte.gz",
             rng.randint(0, 256, (n, 28, 28)).astype(np.uint8), 2051)
        _idx(data_home / "mnist" / f"{prefix}-labels-idx1-ubyte.gz",
             rng.randint(0, 10, (n,)).astype(np.uint8), 2049)
    for mode, n in (("train", 7), ("test", 5)):
        got = PD.MNIST(mode=mode, transform=PT.ToTensor())
        want = RD.MNIST(mode=mode, transform=RT.ToTensor())
        assert len(got) == n
        _same_dataset(got, want)
        assert tuple(got[0][0].shape) == (1, 28, 28)


def test_folder_datasets_read_npy_trees(data_home):
    rng = np.random.RandomState(5)
    root = data_home / "folders"
    for cls, n in (("cat", 2), ("dog", 3)):
        (root / cls).mkdir(parents=True)
        for i in range(n):
            np.save(root / cls / f"{i}.npy", rng.rand(4, 4, 3).astype(
                np.float32))
    (root / "dog" / "notes.txt").write_text("not an image")
    got, want = PD.DatasetFolder(str(root)), RD.DatasetFolder(str(root))
    assert got.classes == want.classes == ["cat", "dog"]
    assert len(got) == len(want) == 5
    for i in range(5):
        (gi, gl), (wi, wl) = got[i], want[i]
        np.testing.assert_array_equal(gi, wi)
        assert int(gl) == int(wl)
    gf = PD.ImageFolder(str(root), transform=PT.Transpose())
    wf = RD.ImageFolder(str(root), transform=RT.Transpose())
    assert gf.samples == wf.samples
    np.testing.assert_array_equal(gf[4][0], wf[4][0])
    assert len(PD.ImageFolder(str(data_home / "missing"))) == 0


def test_a_dataset_through_the_loader_and_fit(data_home):
    """MNIST (synthetic) through ``ToTensor`` and the port's ``DataLoader``
    into ``Model.fit`` of ``LeNet``, as the reference's drive does."""
    with cpu_device():
        tp.seed(0)
        ds = PD.MNIST(mode="train", transform=PT.ToTensor())
        net = tp.vision.models.LeNet(device="cpu")
        model = tp.Model(net)
        model.prepare(tp.optimizer.Adam(1e-3, parameters=net.parameters()),
                      tp.nn.CrossEntropyLoss(), tp.metric.Accuracy())
        model.fit(ds, batch_size=8, epochs=1, verbose=0, shuffle=False)
        logs = model.evaluate(ds, batch_size=20)
        assert set(logs) == {"loss", "acc"} and np.isfinite(logs["loss"])
