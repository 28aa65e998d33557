"""DataSet abstractions (``dataset/DataSet.scala``), ported from
``bigdl_tpu/dataset/dataset.py``: ``LocalDataSet`` (records in memory
plus a transformer chain), the generator-backed dataset and the
``DataSet.array`` / ``DataSet.generator`` factories.

Where the JAX classes read the global ``RNG``, the port takes an
explicit seed: ``LocalDataSet(data, seed=s)`` orders its epochs as the
JAX ``LocalDataSet`` built after ``RNG.set_seed(s)`` does.

Not ported yet: ``DistributedDataSet`` (multi-process sharding) and
``DataSet.image_folder``.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, List, Optional

import numpy as np

from bigdl_tpu_torch.dataset.transformer import Transformer

__all__ = ["AbstractDataSet", "LocalDataSet", "DataSet"]


class AbstractDataSet:
    """(``dataset/DataSet.scala:46``)."""

    def data(self, train: bool) -> Iterator:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self):
        raise NotImplementedError

    def transform(self, transformer: Transformer) -> "AbstractDataSet":
        raise NotImplementedError

    def __rshift__(self, transformer: Transformer) -> "AbstractDataSet":
        return self.transform(transformer)


class LocalDataSet(AbstractDataSet):
    """(``dataset/DataSet.scala:110``).

    Epoch order is deterministic and seekable: epoch 0 iterates the base
    order (the identity until :meth:`shuffle`), and every later epoch's
    permutation comes from a Philox generator keyed by ``(seed, epoch)``,
    so the order is a pure function of the two.  :meth:`set_position`
    re-enters any epoch's order, which is what resume rests on.  The
    training iterator runs on across epochs without a break, so a batch
    may take the end of one epoch and the start of the next."""

    def __init__(self, data, transformers: Optional[List[Transformer]] = None,
                 seed: int = 0):
        self._data = data if isinstance(data, np.ndarray) else list(data)
        self._transformers = list(transformers or [])
        self._perm = np.arange(len(self._data))
        self._epoch = 0
        self._seed = int(seed)
        self._shuffle_seed = self._seed & (2 ** 63 - 1)

    def size(self) -> int:
        return len(self._data)

    def shuffle(self, generator: Optional[np.random.Generator] = None):
        """Draw a new base order from ``generator``; by default from a
        fresh MT19937 of the seed (the draw the JAX ``shuffle`` makes
        first after ``RNG.set_seed(seed)``)."""
        gen = generator or np.random.Generator(np.random.MT19937(self._seed))
        self._perm = gen.permutation(len(self._data))
        return self

    def set_position(self, epoch: int) -> "LocalDataSet":
        """Start the next ``data(train=True)`` iterator at the beginning
        of 0-based ``epoch``."""
        self._epoch = max(int(epoch), 0)
        return self

    def _perm_for_epoch(self, epoch: int) -> np.ndarray:
        if epoch <= 0:
            return self._perm
        gen = np.random.Generator(np.random.Philox(
            key=np.array([self._shuffle_seed, epoch], dtype=np.uint64)))
        return self._perm[gen.permutation(len(self._data))]

    def transform(self, transformer: Transformer) -> "LocalDataSet":
        ds = LocalDataSet.__new__(LocalDataSet)
        ds.__dict__.update(self.__dict__)
        ds._transformers = self._transformers + [transformer]
        return ds

    def _raw_iter(self, train: bool) -> Iterator:
        if train:
            epoch = self._epoch
            while True:
                for i in self._perm_for_epoch(epoch):
                    yield self._data[i]
                epoch += 1
        else:
            for i in range(len(self._data)):
                yield self._data[i]

    def data(self, train: bool = False) -> Iterator:
        it: Iterator = self._raw_iter(train)
        for t in self._transformers:
            it = t(it)
        return it


class _GeneratorDataSet(AbstractDataSet):
    """A callable that makes fresh iterators (streaming sources)."""

    def __init__(self, gen: Callable[[bool], Iterable], size: int,
                 transformers: Optional[List[Transformer]] = None):
        self._gen = gen
        self._size = size
        self._transformers = list(transformers or [])

    def size(self):
        return self._size

    def shuffle(self):
        return self

    def transform(self, transformer):
        return _GeneratorDataSet(self._gen, self._size,
                                 self._transformers + [transformer])

    def data(self, train: bool = False):
        it = iter(self._gen(train))
        for t in self._transformers:
            it = t(it)
        return it


class DataSet:
    """Factories (``object DataSet``, ``dataset/DataSet.scala:319``)."""

    @staticmethod
    def array(data, seed: int = 0) -> LocalDataSet:
        return LocalDataSet(data, seed=seed)

    @staticmethod
    def generator(gen: Callable[[bool], Iterable],
                  size: int) -> AbstractDataSet:
        return _GeneratorDataSet(gen, size)
