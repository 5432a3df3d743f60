"""paddle_tpu_torch's reader decorators, vision datasets and transforms
against the JAX package's on the CPU.

- ``reader``: the same samples in the same order (``shuffle`` under the same
  ``random.seed``), ``buffered``'s error re-raise, ``compose``'s
  ``ComposeNotAligned``, ``batch``.
- ``vision.datasets``: the synthetic sets' bytes and labels equal, every
  dataset and mode; MNIST from gzip'd IDX files; ``DatasetFolder`` and
  ``ImageFolder`` over a directory of ``.npy`` files.
- ``vision.transforms``: every class and functional form on the same numpy
  image under the same ``np.random.seed``: exactly where the transform
  moves or picks pixels, within 1e-6 (absolute, on values in [0, 1] or
  [0, 255]) where it computes in float; the random draws of the two
  packages are the same draws, so the global generator ends in the same
  state.
"""
import gzip
import random
import struct

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.reader as jreader
import paddle_tpu.vision.datasets as jds
import paddle_tpu.vision.transforms as jT
import paddle_tpu_torch as P
import paddle_tpu_torch.reader as preader
import paddle_tpu_torch.vision.datasets as pds
import paddle_tpu_torch.vision.transforms as pT

FLOAT_TOL = 1e-6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


# ------------------------------------------------------------ reader

def _r(n):
    return lambda: iter(range(n))


def test_reader_decorators_match():
    for pkg in (preader, jreader):
        assert list(pkg.chain(_r(2), _r(3))()) == [0, 1, 0, 1, 2]
        assert list(pkg.firstn(_r(10), 4)()) == [0, 1, 2, 3]
        assert list(pkg.map_readers(lambda a, b: a * b, _r(4), _r(3))()) == [0, 1, 4]
        assert list(pkg.compose(_r(3), lambda: iter([(7, 8)] * 3))()) == [(0, 7, 8),
                                                                            (1, 7, 8),
                                                                            (2, 7, 8)]
        assert list(pkg.compose(_r(2), _r(3), check_alignment=False)()) == [(0, 0), (1, 1)]
        with pytest.raises(pkg.ComposeNotAligned):
            list(pkg.compose(_r(2), _r(3))())
        assert list(pkg.buffered(_r(50), 4)()) == list(range(50))
    random.seed(3)
    got = list(preader.shuffle(_r(25), 7)())
    random.seed(3)
    assert got == list(jreader.shuffle(_r(25), 7)()) and sorted(got) == list(range(25))


def test_buffered_reraises_and_stops_its_producer():
    def bad():
        yield 1
        yield 2
        raise OSError("disk gone")

    for pkg in (preader, jreader):
        it = pkg.buffered(bad, 1)()
        assert [next(it), next(it)] == [1, 2]
        with pytest.raises(OSError, match="disk gone"):
            next(it)
    it = preader.buffered(_r(1000), 2)()
    assert next(it) == 0
    it.close()   # the producer, blocked on a full queue, sees the stop flag


@pytest.mark.parametrize("drop", [False, True])
def test_batch_matches(drop):
    got = list(P.batch(_r(10), 4, drop_last=drop)())
    assert got == list(paddle.batch(_r(10), 4, drop_last=drop)())
    assert got[0] == [0, 1, 2, 3] and len(got) == (2 if drop else 3)


# ------------------------------------------------------------ datasets

DATASETS = [("MNIST", dict(size=300)), ("FashionMNIST", dict(size=64, seed=4)),
            ("Cifar10", dict(size=40)), ("Cifar100", dict(size=40, seed=2)),
            ("Flowers", dict(size=8)), ("VOC2012", dict(size=4))]


@pytest.mark.parametrize("name,kw", DATASETS, ids=[d[0] for d in DATASETS])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_synthetic_sets_are_the_jax_packages_bytes(name, kw, mode):
    p, j = getattr(pds, name)(mode=mode, **kw), getattr(jds, name)(mode=mode, **kw)
    assert len(p) == len(j) > 0
    assert p.images.dtype == j.images.dtype
    np.testing.assert_array_equal(p.images, j.images)
    np.testing.assert_array_equal(p.labels, j.labels)
    for i in (0, len(p) - 1):
        for a, b in zip(p[i], j[i]):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)


def _idx_files(tmp_path, n=5):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labs = rng.randint(0, 10, n).astype(np.uint8)
    ip, lp = str(tmp_path / "img.gz"), str(tmp_path / "lab.gz")
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labs.tobytes())
    return ip, lp, imgs, labs


def test_mnist_reads_idx_files_and_applies_its_transform(tmp_path):
    ip, lp, imgs, labs = _idx_files(tmp_path)
    t = pT.Normalize(0.5, 0.5)
    p = pds.MNIST(image_path=ip, label_path=lp, transform=t)
    j = jds.MNIST(image_path=ip, label_path=lp, transform=jT.Normalize(0.5, 0.5))
    assert len(p) == len(j) == 5
    np.testing.assert_array_equal(p.images, imgs)
    for i in range(5):
        (pi, pl), (ji, jl) = p[i], j[i]
        np.testing.assert_array_equal(pi, ji)
        assert pl.tolist() == jl.tolist() == [labs[i]]


def test_folder_datasets_match(tmp_path):
    rng = np.random.RandomState(1)
    for cls in ("cat", "dog"):
        (tmp_path / cls).mkdir()
        for k in range(3):
            np.save(tmp_path / cls / f"{k}.npy", rng.rand(4, 4).astype(np.float32))
    (tmp_path / "dog" / "notes.txt").write_text("not an image")
    p, j = pds.DatasetFolder(str(tmp_path)), jds.DatasetFolder(str(tmp_path))
    assert p.classes == j.classes == ["cat", "dog"] and p.samples == j.samples
    for i in range(len(p)):
        np.testing.assert_array_equal(p[i][0], j[i][0])
        assert p[i][1] == j[i][1]
    pi, ji = pds.ImageFolder(str(tmp_path)), jds.ImageFolder(str(tmp_path))
    assert pi.samples == ji.samples and len(pi) == 6
    np.testing.assert_array_equal(pi[3][0], ji[3][0])


# ------------------------------------------------------------ transforms

def _img(kind, seed=0):
    rng = np.random.RandomState(seed)
    return {"chw": rng.rand(3, 12, 10).astype(np.float32),
            "hwc": rng.rand(12, 10, 3).astype(np.float32),
            "hwc255": (rng.rand(12, 10, 3) * 255).astype(np.float32),
            "u8": (rng.rand(12, 10, 3) * 255).astype(np.uint8),
            "gray": rng.rand(1, 12, 10).astype(np.float32),
            "hw": rng.rand(12, 10).astype(np.float32)}[kind]


# name: (the transform of a module, image kinds); each is built again for
# each package from the same arguments
TRANSFORMS = {
    "Compose": (lambda T: T.Compose([T.RandomHorizontalFlip(1.0), T.Normalize(0.5, 0.2)]),
                ["chw"]),
    "ToTensor": (lambda T: T.ToTensor(), ["hwc", "hwc255", "hw", "chw"]),
    "Normalize": (lambda T: T.Normalize([0.1, 0.2, 0.3], [0.5, 0.6, 0.7]), ["chw"]),
    "Resize": (lambda T: T.Resize((7, 15)), ["chw", "hwc", "hw"]),
    "RandomHorizontalFlip": (lambda T: T.RandomHorizontalFlip(), ["chw", "hwc"]),
    "RandomVerticalFlip": (lambda T: T.RandomVerticalFlip(), ["chw", "hwc"]),
    "CenterCrop": (lambda T: T.CenterCrop((6, 5)), ["chw", "hw"]),
    "RandomCrop": (lambda T: T.RandomCrop(8), ["chw", "hwc"]),
    "RandomCrop_padding": (lambda T: T.RandomCrop((13, 9), padding=(1, 2)), ["chw", "hwc"]),
    "RandomCrop_pad_if_needed": (lambda T: T.RandomCrop(14, pad_if_needed=True), ["chw"]),
    "RandomResizedCrop": (lambda T: T.RandomResizedCrop(6), ["chw", "hwc"]),
    "Pad": (lambda T: T.Pad(2, fill=0.5), ["chw", "hwc"]),
    "Pad_reflect": (lambda T: T.Pad((1, 2, 3, 4), padding_mode="reflect"), ["chw"]),
    "Pad_edge": (lambda T: T.Pad([1, 2], padding_mode="edge"), ["hw"]),
    "Grayscale": (lambda T: T.Grayscale(3), ["chw", "hwc", "gray", "hw"]),
    "BrightnessTransform": (lambda T: T.BrightnessTransform(0.4), ["chw", "hwc255"]),
    "ContrastTransform": (lambda T: T.ContrastTransform(0.4), ["chw", "hwc255"]),
    "SaturationTransform": (lambda T: T.SaturationTransform(0.4), ["chw", "hwc"]),
    "HueTransform": (lambda T: T.HueTransform(0.3), ["chw", "hwc255", "gray"]),
    "ColorJitter": (lambda T: T.ColorJitter(0.2, 0.3, 0.4, 0.1), ["chw", "hwc"]),
    "RandomRotation": (lambda T: T.RandomRotation(30), ["chw", "hwc", "hw"]),
    "Transpose": (lambda T: T.Transpose(), ["hwc"]),
    "to_tensor": (lambda T: T.to_tensor, ["u8", "hwc", "hw", "chw"]),
    "to_tensor_hwc": (lambda T: lambda im: T.to_tensor(im, data_format="HWC"), ["hw"]),
    "hflip": (lambda T: T.hflip, ["chw", "hwc", "hw"]),
    "vflip": (lambda T: T.vflip, ["chw", "hwc"]),
    "resize": (lambda T: lambda im: T.resize(im, 9), ["chw", "hwc"]),
    "pad": (lambda T: lambda im: T.pad(im, (1, 2), fill=3.0), ["chw"]),
    "rotate": (lambda T: lambda im: T.rotate(im, 47, fill=-1.0), ["chw", "hwc", "hw"]),
    "to_grayscale": (lambda T: T.to_grayscale, ["chw", "hwc"]),
    "crop": (lambda T: lambda im: T.crop(im, 2, 1, 5, 6), ["chw", "hwc"]),
    "center_crop": (lambda T: lambda im: T.center_crop(im, 4), ["chw"]),
    "adjust_brightness": (lambda T: lambda im: T.adjust_brightness(im, 1.7), ["u8", "chw"]),
    "adjust_contrast": (lambda T: lambda im: T.adjust_contrast(im, 0.6), ["chw", "hwc255"]),
    "adjust_hue": (lambda T: lambda im: T.adjust_hue(im, -0.2), ["chw", "hwc", "gray"]),
    "normalize": (lambda T: lambda im: T.normalize(im, [0.4] * 3, [0.3] * 3), ["chw"]),
    "normalize_hwc": (lambda T: lambda im: T.normalize(im, [0.4] * 3, [0.3] * 3,
                                                       data_format="HWC"), ["hwc"]),
}
# the transforms that compute in float (the rest move or pick pixels)
FLOAT = {"Compose", "ToTensor", "Normalize", "Grayscale", "BrightnessTransform",
         "ContrastTransform", "SaturationTransform", "HueTransform", "ColorJitter",
         "to_tensor", "to_grayscale", "adjust_brightness", "adjust_contrast", "adjust_hue",
         "normalize", "normalize_hwc"}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_every_transform_matches_under_the_same_seed(name):
    make, kinds = TRANSFORMS[name]
    for kind in kinds:
        for seed in (0, 1, 2):
            img = _img(kind)
            np.random.seed(seed)
            got = make(pT)(img.copy())
            state = np.random.get_state()[1].copy()
            np.random.seed(seed)
            want = _np(make(jT)(img.copy()))
            assert np.array_equal(np.random.get_state()[1], state), (name, "draws")
            if name.startswith("to_tensor"):
                assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
                assert got.dtype == torch.float32
            got = _np(got)
            assert got.shape == want.shape and got.dtype == want.dtype, (name, kind)
            if name in FLOAT:
                np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL,
                                           err_msg=f"{name} {kind}")
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{name} {kind}")


def test_random_crop_too_small_raises_and_base_transform_dispatches():
    with pytest.raises(ValueError, match="smaller than crop"):
        pT.RandomCrop(20)(_img("chw"))

    class AddOne(pT.BaseTransform):
        def _apply_image(self, image):
            return image + 1

    t = AddOne(keys=("image", "label"))
    img, lab = t((np.zeros(2), 7))
    assert img.tolist() == [1.0, 1.0] and lab == 7
    assert AddOne()(np.zeros(1)).tolist() == [1.0]
