"""Built-in vision datasets (reference: ``paddle_tpu/vision/datasets.py``;
Paddle's ``python/paddle/vision/datasets/``).

With no real files given, each dataset is the reference's deterministic
synthetic sample, with the right shapes, dtypes and cardinality: its
draws come from ``RandomState(0)`` (train) or ``RandomState(1)`` in the
reference's order, so every item equals the reference's. ``MNIST`` reads
real gzip idx files (``image_path``, ``label_path``) and
``DatasetFolder`` / ``ImageFolder`` real image folders (through PIL,
which the port needs only there). Unlike the reference, an image that
cannot be read raises instead of becoming zeros.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..io.dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers",
           "ImageFolder", "DatasetFolder", "VOC2012"]


class MNIST(Dataset):
    NUM_CLASSES = 10
    IMAGE_SHAPE = (1, 28, 28)

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None,
                 synthetic_size=None):
        self.mode = mode
        self.transform = transform
        self._images, self._labels = self._load(image_path, label_path, mode,
                                                synthetic_size)

    def _load(self, image_path, label_path, mode, synthetic_size):
        if (image_path and os.path.exists(image_path) and label_path
                and os.path.exists(label_path)):
            with gzip.open(image_path, "rb") as f:
                _, n, r, c = struct.unpack(">IIII", f.read(16))
                images = np.frombuffer(f.read(), dtype=np.uint8).reshape(
                    n, 1, r, c)
            with gzip.open(label_path, "rb") as f:
                _, n = struct.unpack(">II", f.read(8))
                labels = np.frombuffer(f.read(), dtype=np.uint8)
            return images, labels
        n = synthetic_size or (6000 if mode == "train" else 1000)
        rng = np.random.RandomState(0 if mode == "train" else 1)
        labels = rng.randint(0, 10, n).astype(np.int64)
        # class-dependent blobs so a model can actually learn from the synthetic set
        images = np.zeros((n, 1, 28, 28), dtype=np.uint8)
        for i, l in enumerate(labels):
            canvas = rng.rand(28, 28) * 64
            r0, c0 = 2 + (l % 5) * 5, 2 + (l // 5) * 12
            canvas[r0 : r0 + 6, c0 : c0 + 6] += 180
            images[i, 0] = np.clip(canvas, 0, 255)
        return images, labels

    def __getitem__(self, idx):
        img = self._images[idx].astype(np.float32)
        label = np.asarray(self._labels[idx], dtype=np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self._labels)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    NUM_CLASSES = 10
    IMAGE_SHAPE = (3, 32, 32)

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None, synthetic_size=None):
        self.transform = transform
        n = synthetic_size or (5000 if mode == "train" else 1000)
        rng = np.random.RandomState(0 if mode == "train" else 1)
        self._labels = rng.randint(0, self.NUM_CLASSES, n).astype(np.int64)
        self._images = (rng.rand(n, *self.IMAGE_SHAPE) * 255).astype(np.uint8)
        for i, l in enumerate(self._labels):
            self._images[i, l % 3, (l * 3) % 32 : (l * 3) % 32 + 4] = 255

    def __getitem__(self, idx):
        img = self._images[idx].astype(np.float32)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(self._labels[idx], dtype=np.int64)

    def __len__(self):
        return len(self._labels)


class Cifar100(Cifar10):
    NUM_CLASSES = 100


class Flowers(Cifar10):
    NUM_CLASSES = 102
    IMAGE_SHAPE = (3, 64, 64)


class DatasetFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.samples = []
        classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        ) if os.path.isdir(root) else []
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        for c in classes:
            for fn in sorted(os.listdir(os.path.join(root, c))):
                self.samples.append((os.path.join(root, c, fn), self.class_to_idx[c]))

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = _load_image(path)
        if self.transform:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(DatasetFolder):
    pass


def _load_image(path):
    """The RGB image at ``path`` as a float32 CHW array. PIL's errors
    propagate: the reference returns a 3 x 32 x 32 zero image for any
    failure (``paddle_tpu/vision/datasets.py:129-135``)."""
    from PIL import Image

    with Image.open(path) as img:
        rgb = np.asarray(img.convert("RGB"))
    return rgb.transpose(2, 0, 1).astype(np.float32)


class VOC2012(Dataset):
    """VOC2012 segmentation pairs (reference: vision/datasets/voc2012.py —
    (image, segmentation mask) samples). Synthetic in this zero-egress
    environment, like the other vision datasets here: blocky masks with the
    matching color painted into the image."""

    NUM_CLASSES = 21
    IMAGE_SHAPE = (3, 64, 64)

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None, synthetic_size=None):
        self.transform = transform
        n = synthetic_size or (200 if mode == "train" else 50)
        rng = np.random.RandomState(0 if mode == "train" else 1)
        c, h, w = self.IMAGE_SHAPE
        self._images = (rng.rand(n, c, h, w) * 255).astype(np.uint8)
        self._masks = np.zeros((n, h, w), np.int64)
        for i in range(n):
            cls = rng.randint(1, self.NUM_CLASSES)
            y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
            self._masks[i, y0:y0 + h // 2, x0:x0 + w // 2] = cls
            self._images[i, cls % 3, y0:y0 + h // 2, x0:x0 + w // 2] = 255

    def __getitem__(self, idx):
        img = self._images[idx].astype(np.float32)
        if self.transform is not None:
            img = self.transform(img)
        return img, self._masks[idx]

    def __len__(self):
        return len(self._images)
