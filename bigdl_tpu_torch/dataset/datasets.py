"""Dataset readers, ported from ``bigdl_tpu/dataset/datasets.py``: MNIST
(IDX files) and CIFAR-10 (the python batches of
``cifar-10-batches-py``).

A reader parses the standard files when the folder holds them; with no
folder, or none of the files, it makes deterministic class-dependent
synthetic images of the right shapes, the same arrays from the same
seed as the JAX package.  Not ported yet: news20, MovieLens and
``image_folder``.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Optional, Tuple

import numpy as np

__all__ = ["load_mnist", "load_cifar10", "TRAIN_MEAN", "TRAIN_STD"]

# MNIST normalization constants (pyspark/bigdl/dataset/mnist.py)
TRAIN_MEAN = 0.13066047740239506 * 255
TRAIN_STD = 0.3081078 * 255


def _open(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def _read_idx_images(path: str) -> np.ndarray:
    """An IDX3 image file (``mnist.py read_data_sets``)."""
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad IDX image magic {magic} in {path}")
        return np.frombuffer(f.read(n * rows * cols), np.uint8).reshape(
            n, rows, cols)


def _read_idx_labels(path: str) -> np.ndarray:
    with _open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad IDX label magic {magic} in {path}")
        return np.frombuffer(f.read(n), np.uint8)


def _synthetic_images(n: int, h: int, w: int, c: int, classes: int,
                      seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic class-dependent images: each class has its own
    mean pattern, so a model can fit them."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n)
    base = rng.uniform(0, 255, (classes, h, w, c))
    imgs = np.clip(base[labels] + rng.normal(0, 30, (n, h, w, c)),
                   0, 255).astype(np.uint8)
    if c == 1:
        imgs = imgs[..., 0]
    return imgs, labels.astype(np.int64)


def load_mnist(data_dir: Optional[str] = None, split: str = "train",
               synthetic_size: int = 1024
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(images [N, 28, 28] uint8, labels [N] int64, 0-based) from the
    IDX files (``train-images-idx3-ubyte[.gz]``, ...) under
    ``data_dir``, else synthetic."""
    names = {"train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
             "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")}
    if data_dir:
        img_base, lbl_base = names[split]
        for suffix in ("", ".gz"):
            ip = os.path.join(data_dir, img_base + suffix)
            lp = os.path.join(data_dir, lbl_base + suffix)
            if os.path.exists(ip) and os.path.exists(lp):
                return (_read_idx_images(ip),
                        _read_idx_labels(lp).astype(np.int64))
    return _synthetic_images(synthetic_size, 28, 28, 1, 10,
                             seed=0 if split == "train" else 1)


def load_cifar10(data_dir: Optional[str] = None, split: str = "train",
                 synthetic_size: int = 1024
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(images [N, 32, 32, 3] uint8, labels [N] int64) from the python
    batches under ``data_dir/cifar-10-batches-py`` (``data_batch_1..5``
    or ``test_batch``, the format the CIFAR-10 site ships), else
    synthetic.  Those batches are pickles: read only files you trust."""
    if data_dir:
        batch_dir = os.path.join(data_dir, "cifar-10-batches-py")
        if os.path.isdir(batch_dir):
            files = ([f"data_batch_{i}" for i in range(1, 6)]
                     if split == "train" else ["test_batch"])
            imgs, labels = [], []
            for fn in files:
                with open(os.path.join(batch_dir, fn), "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                imgs.append(np.asarray(d[b"data"], np.uint8)
                            .reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
                labels.append(np.asarray(d[b"labels"], np.int64))
            return np.concatenate(imgs), np.concatenate(labels)
    return _synthetic_images(synthetic_size, 32, 32, 3, 10,
                             seed=2 if split == "train" else 3)
