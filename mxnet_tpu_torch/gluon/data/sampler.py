"""Samplers (parity: python/mxnet/gluon/data/sampler.py).

Counterpart of ``mxnet_tpu/gluon/data/sampler.py``. ``RandomSampler``
shuffles with numpy's global state (``np.random.shuffle``), as the JAX
package and upstream MXNet do, so one ``np.random.seed`` gives every
package the same order.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]


class Sampler:
    """Base sampler: iterates sample indices (parity: data.Sampler)."""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    """0, 1, ..., length-1 (parity: data.SequentialSampler)."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(range(self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """A fresh permutation per pass (parity: data.RandomSampler)."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        indices = np.arange(self._length)
        np.random.shuffle(indices)
        return iter(indices)

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Group a sampler's indices into batches (parity: data.BatchSampler):
    ``last_batch`` keeps the short tail, discards it, or rolls it over
    into the next pass."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                return
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError(
                    "last_batch must be one of keep/discard/rollover, "
                    "got %s" % self._last_batch)

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) \
                // self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        if self._last_batch == "rollover":
            return (len(self._prev) + len(self._sampler)) \
                // self._batch_size
        raise ValueError("last_batch must be one of keep/discard/rollover")
