"""Datasets of the port (counterpart of paddle_tpu/vision/datasets/;
reference python/paddle/vision/datasets/): ``MNIST``, ``FashionMNIST``,
``Cifar10``, ``Cifar100``, ``DatasetFolder``, ``ImageFolder``, ``Flowers``
and ``VOC2012``. Samples are numpy arrays on the host; the DataLoader
collates and moves them.

MNIST reads the gzip'd IDX files a user passes (``image_path``,
``label_path``); ``DatasetFolder`` and ``ImageFolder`` read a directory tree
(``.npy`` with numpy, image files with PIL, imported when the first one is
read). Nothing is downloaded: where no files are given, each dataset makes
the JAX package's deterministic synthetic set (the same shapes and dtypes,
class-dependent patterns that a model can learn) from numpy's
``RandomState(seed)`` for ``mode="train"`` and ``RandomState(seed + 1)``
otherwise, the same draws in the same order, so both packages see the same
bytes.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ...io import Dataset


class MNIST(Dataset):
    def __init__(self, image_path=None, label_path=None, mode="train", transform=None,
                 download=True, backend=None, size=2048, seed=0):
        self.mode = mode
        self.transform = transform
        images = labels = None
        if image_path and label_path and os.path.exists(image_path):
            with gzip.open(image_path, "rb") as f:
                magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
                images = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)
            with gzip.open(label_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                labels = np.frombuffer(f.read(), np.uint8)
        if images is None:
            # deterministic synthetic data: class-dependent blob patterns so a model
            # can actually learn (loss decreases) in hermetic tests
            rng = np.random.RandomState(seed if mode == "train" else seed + 1)
            n = size if mode == "train" else max(size // 4, 256)
            labels = rng.randint(0, 10, n).astype(np.int64)
            images = np.zeros((n, 28, 28), np.float32)
            for i, lab in enumerate(labels):
                img = rng.rand(28, 28).astype(np.float32) * 0.3
                r, c = divmod(int(lab), 4)
                img[4 + r * 7:11 + r * 7, 3 + c * 6:9 + c * 6] += 0.7
                images[i] = img
            images = (images * 255).clip(0, 255).astype(np.uint8)
        self.images = images
        self.labels = labels.astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32) / 255.0
        img = img.reshape(1, 28, 28)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray([self.labels[idx]], np.int64)

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    def __init__(self, data_file=None, mode="train", transform=None, download=True,
                 backend=None, size=1024, seed=0):
        self.transform = transform
        rng = np.random.RandomState(seed if mode == "train" else seed + 1)
        n = size if mode == "train" else max(size // 4, 128)
        self.labels = rng.randint(0, 10, n).astype(np.int64)
        self.images = (rng.rand(n, 3, 32, 32) * 255).astype(np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32) / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray([self.labels[idx]], np.int64)

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        rng = np.random.RandomState(7)
        self.labels = rng.randint(0, 100, len(self.labels)).astype(np.int64)


class DatasetFolder(Dataset):
    """Directory-per-class image tree (reference vision/datasets/folder.py).
    Loads .npy arrays or image files (via PIL when available); samples are
    (image, class_index) with classes sorted by folder name."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or _default_loader
        extensions = extensions or (".npy", ".png", ".jpg", ".jpeg", ".bmp")
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                path = os.path.join(cdir, fname)
                ok = (is_valid_file(path) if is_valid_file
                      else fname.lower().endswith(extensions))
                if ok:
                    self.samples.append((path, self.class_to_idx[c]))

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Flat/recursive image list without labels (reference folder.py:ImageFolder)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or _default_loader
        extensions = extensions or (".npy", ".png", ".jpg", ".jpeg", ".bmp")
        self.samples = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fname in sorted(files):
                path = os.path.join(dirpath, fname)
                ok = (is_valid_file(path) if is_valid_file
                      else fname.lower().endswith(tuple(extensions)))
                if ok:
                    self.samples.append(path)

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)


def _default_loader(path):
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image

        return np.asarray(Image.open(path))
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(f"cannot load {path}: PIL unavailable") from e


class Flowers(Dataset):
    """Flowers-102 (synthetic fallback, shapes per the reference dataset)."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None,
                 size=256, seed=0):
        self.transform = transform
        rng = np.random.RandomState(seed if mode == "train" else seed + 1)
        n = size if mode == "train" else max(size // 4, 64)
        self.labels = rng.randint(0, 102, n).astype(np.int64)
        self.images = (rng.rand(n, 3, 96, 96) * 255).astype(np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32) / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray([self.labels[idx]], np.int64)

    def __len__(self):
        return len(self.images)


class VOC2012(Dataset):
    """VOC2012 segmentation (synthetic fallback: image + label mask pairs)."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None, size=64, seed=0):
        self.transform = transform
        rng = np.random.RandomState(seed if mode == "train" else seed + 1)
        n = size if mode == "train" else max(size // 4, 16)
        self.images = (rng.rand(n, 3, 128, 128) * 255).astype(np.uint8)
        self.labels = rng.randint(0, 21, (n, 128, 128)).astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32) / 255.0
        lab = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, lab

    def __len__(self):
        return len(self.images)
