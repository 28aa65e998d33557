"""The data pipeline of the port against the JAX package: samples into
minibatches, the epoch order of ``LocalDataSet`` (and after
``set_position`` and ``shuffle``), and the MNIST / CIFAR-10 readers on
their synthetic fallback and on small files in their formats, written
here.  Everything is numpy: arrays are held equal, bit for bit."""

import gzip
import os
import pickle
import struct

import numpy as np
import pytest

from bigdl_tpu.dataset import datasets as jdatasets
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.sample import PaddingParam as JPaddingParam
from bigdl_tpu.dataset.sample import Sample as JSample
from bigdl_tpu.dataset.transformer import SampleToMiniBatch as JToBatch
from bigdl_tpu.utils.rng import RNG
from bigdl_tpu_torch.dataset import datasets
from bigdl_tpu_torch.dataset import DataSet, MiniBatch, PaddingParam, Sample
from bigdl_tpu_torch.dataset.transformer import (Identity,
                                                 SampleToMiniBatch)


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _records(n, ragged=False):
    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        t = 2 + i % 3 if ragged else 3
        out.append((rng.randn(t, 4).astype(np.float32),
                    np.int64(rng.randint(0, 10))))
    return out


@pytest.mark.parametrize("ragged,fixed,drop_last", [
    (False, None, False), (True, None, False), (True, 6, True)])
def test_samples_to_minibatches_match_jax(ragged, fixed, drop_last):
    recs = _records(10, ragged)
    tb = SampleToMiniBatch(4, PaddingParam(-1.0, fixed) if ragged else None,
                           drop_last=drop_last)
    jb = JToBatch(4, JPaddingParam(-1.0, fixed) if ragged else None,
                  drop_last=drop_last)
    got = list(tb(Sample(x, y) for x, y in recs))
    want = list(jb(JSample(x, y) for x, y in recs))
    assert [b.size() for b in got] == [b.size() for b in want]
    for g, w in zip(got, want):
        _equal(g.inputs, w.inputs)
        _equal(g.targets, w.targets)
        np.testing.assert_array_equal(g.get_input(), w.get_input())
        np.testing.assert_array_equal(g.slice(1, 2).get_target(),
                                      w.slice(1, 2).get_target())
    chained = (Identity() >> SampleToMiniBatch(4))
    assert [b.size() for b in chained(Sample(x, y) for x, y in recs)] \
        == [4, 4, 2]
    assert MiniBatch([np.zeros((2, 3))]).get_target() is None


def _order(ds, n):
    it = ds.data(train=True)
    return [int(next(it)[0]) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 42, 2 ** 40 + 7])
def test_local_dataset_epoch_order_matches_jax(seed):
    n = 13
    recs = [(np.int64(i), np.int64(i % 3)) for i in range(n)]
    RNG.set_seed(seed)
    jds = JDataSet.array(recs)
    tds = DataSet.array(recs, seed=seed)
    # epochs 0-2 straight through, then re-entered at each epoch
    assert _order(tds, 3 * n) == _order(jds, 3 * n)
    assert _order(tds, n)[:n] == list(range(n))
    for epoch in (0, 1, 2):
        assert _order(tds.set_position(epoch), n) \
            == _order(jds.set_position(epoch), n)
    # a shuffled base order: the first draw after RNG.set_seed(seed)
    RNG.set_seed(seed)
    jds.shuffle()
    tds.shuffle()
    for epoch in (0, 1, 2):
        assert _order(tds.set_position(epoch), n) \
            == _order(jds.set_position(epoch), n)
    assert list(tds.data(train=False))[:3] == recs[:3]
    # batches of Samples: a transformed dataset keeps the seed and the
    # position, and a batch runs across the epoch boundary
    RNG.set_seed(seed)
    jb = JDataSet.array([JSample(x, y) for x, y in recs]).transform(
        JToBatch(5)).set_position(2)
    tb = DataSet.array([Sample(x, y) for x, y in recs], seed=seed) \
        .transform(SampleToMiniBatch(5)).set_position(2)
    got, want = _take(tb, 4), _take(jb, 4)
    assert [b.size() for b in got] == [5, 5, 5, 5]
    for g, w in zip(got, want):
        _equal(g.inputs + g.targets, w.inputs + w.targets)


def _take(ds, k):
    it = ds.data(train=True)
    return [next(it) for _ in range(k)]


def test_synthetic_readers_match_jax():
    for split in ("train", "test"):
        _equal(datasets.load_cifar10(None, split, synthetic_size=48),
               jdatasets.load_cifar10(None, split, synthetic_size=48))
        _equal(datasets.load_mnist(None, split, synthetic_size=48),
               jdatasets.load_mnist(None, split, synthetic_size=48))


def _write_idx(root, prefix, imgs, labels, gz):
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    with opener(os.path.join(root, f"{prefix}-images-idx3-ubyte{suffix}"),
                "wb") as f:
        f.write(struct.pack(">IIII", 2051, *imgs.shape) + imgs.tobytes())
    with opener(os.path.join(root, f"{prefix}-labels-idx1-ubyte{suffix}"),
                "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)) + labels.tobytes())


def test_file_readers_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    mnist = tmp_path / "mnist"
    mnist.mkdir()
    _write_idx(mnist, "train", rng.randint(0, 256, (5, 28, 28), np.uint8),
               rng.randint(0, 10, 5).astype(np.uint8), gz=False)
    _write_idx(mnist, "t10k", rng.randint(0, 256, (3, 28, 28), np.uint8),
               rng.randint(0, 10, 3).astype(np.uint8), gz=True)
    cifar = tmp_path / "cifar" / "cifar-10-batches-py"
    cifar.mkdir(parents=True)
    for name, n in [(f"data_batch_{i}", 2 + i) for i in range(1, 6)] \
            + [("test_batch", 4)]:
        with open(cifar / name, "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (n, 3072), np.uint8),
                         b"labels": list(rng.randint(0, 10, n))}, f)
    for split in ("train", "test"):
        got = datasets.load_mnist(str(mnist), split)
        _equal(got, jdatasets.load_mnist(str(mnist), split))
        assert got[0].shape[0] == (5 if split == "train" else 3)
        got = datasets.load_cifar10(str(tmp_path / "cifar"), split)
        _equal(got, jdatasets.load_cifar10(str(tmp_path / "cifar"), split))
        assert got[0].shape[1:] == (32, 32, 3)
    bad = tmp_path / "bad"
    bad.mkdir()
    _write_idx(bad, "train", np.zeros((1, 28, 28), np.uint8),
               np.zeros(1, np.uint8), gz=False)
    with open(bad / "train-images-idx3-ubyte", "r+b") as f:
        f.write(struct.pack(">I", 7))
    with pytest.raises(ValueError, match="magic"):
        datasets.load_mnist(str(bad), "train")


def test_generator_dataset_makes_fresh_batched_iterators():
    recs = _records(7)
    ds = DataSet.generator(lambda train: (Sample(x, y) for x, y in recs),
                           size=7).transform(SampleToMiniBatch(3))
    assert ds.size() == 7 and ds.shuffle() is ds
    for _ in range(2):
        got = list(ds.data(train=True))
        assert [b.size() for b in got] == [3, 3, 1]
        np.testing.assert_array_equal(got[2].get_input()[0], recs[6][0])
