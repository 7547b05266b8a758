"""Gluon DataLoader (parity: python/mxnet/gluon/data/dataloader.py).

Counterpart of ``mxnet_tpu/gluon/data/dataloader.py``. Batches are host
NDArrays (``cpu()``), as upstream's are; a training loop moves them to
its device (``as_in_context``). With ``pin_memory=True`` every batch
array is a page-locked host tensor, so that copy is asynchronous on the
current stream (PyTorch's pinned-memory allocator keeps the buffer
until the copy is done); it needs a CUDA device. Two worker modes:

- threads (``thread_pool=True``, the default): each thread assembles
  whole batches; the order is the sampler's;
- processes (``thread_pool=False``, upstream's mode): workers started
  with ``spawn`` that never touch the card. They batch the dataset's
  host items (``Dataset.raw_item``) with numpy and ship each batch
  through POSIX shared memory; the main process copies it out, unlinks
  it and wraps it. A dataset without host items (its transforms build
  NDArrays) or a custom ``batchify_fn`` falls back to threads with a
  warning, as in the JAX package.
"""
from __future__ import annotations

import queue as _queue
import threading
import warnings

import numpy as np
import torch

from ...base import MXNetError
from ...context import cpu
from ...ndarray.ndarray import NDArray
from ...ndarray import array as nd_array
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def _numpy_batchify(data):
    """Worker-side batchify over host items (no NDArray)."""
    if isinstance(data[0], (tuple, list)):
        return [_numpy_batchify(list(i)) for i in zip(*data)]
    return np.stack([np.asarray(d) for d in data])


def _tree_to_shm(tree, shm_list):
    """numpy tree -> picklable descriptor, the arrays moved into POSIX
    shared memory. The segment stays registered with the resource
    tracker (a crash-cleanup net); the consumer unregisters it when it
    unlinks."""
    from multiprocessing import shared_memory
    if isinstance(tree, list):
        return ("list", [_tree_to_shm(t, shm_list) for t in tree])
    arr = np.ascontiguousarray(tree)
    shm = shared_memory.SharedMemory(create=True, size=max(arr.nbytes, 1))
    shm.buf[:arr.nbytes] = arr.tobytes()
    shm_list.append(shm)
    return ("shm", shm.name, arr.shape, str(arr.dtype))


def _numpy_from_shm(desc):
    """Descriptor -> numpy tree; copies out of shared memory, then
    unlinks it."""
    from multiprocessing import shared_memory
    if desc[0] == "list":
        return [_numpy_from_shm(d) for d in desc[1]]
    _, name, shape, dtype = desc
    shm = shared_memory.SharedMemory(name=name)
    try:
        arr = np.frombuffer(shm.buf, dtype=dtype)[:int(np.prod(shape))] \
            .reshape(shape).copy()
    finally:
        shm.close()
        shm.unlink()      # also drops the segment from the resource tracker
    return arr


def _proc_worker(source, idx_q, out_q):
    """Worker process: numpy and shared memory only, never the card."""
    while True:
        job = idx_q.get()
        if job is None:
            return
        seq, indices = job
        try:
            batch = _numpy_batchify([source.raw_item(int(i))
                                     for i in indices])
            shms = []
            desc = _tree_to_shm(batch, shms)
            out_q.put((seq, desc, None))
            for s in shms:
                s.close()         # the main process owns the segment now
        except Exception as e:    # surface worker errors to the parent
            out_q.put((seq, None, "%s: %s" % (type(e).__name__, e)))


def _host_array(a):
    return nd_array(a, ctx=cpu())


def default_batchify_fn(data):
    """Stack a batch's items into host NDArrays, a list of them for
    tuple items (parity: dataloader.default_batchify_fn)."""
    if isinstance(data[0], NDArray):
        return _host_array(np.stack([d.asnumpy() for d in data]))
    if isinstance(data[0], tuple):
        return [default_batchify_fn(list(i)) for i in zip(*data)]
    return _host_array(np.asarray(data))


def _pin(tree):
    if isinstance(tree, (list, tuple)):
        return [_pin(t) for t in tree]
    if isinstance(tree, NDArray) and tree._data.device.type == "cpu":
        return NDArray(tree._data.pin_memory(), cpu())
    return tree


class DataLoader:
    """(parity: gluon.data.DataLoader)"""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=True):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError("batch_size required when no batch_sampler")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError("shuffle is exclusive with a custom "
                                 "sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif sampler is not None or batch_size is not None or shuffle \
                or last_batch is not None:
            raise MXNetError("batch_sampler is exclusive with batch_size, "
                             "shuffle, sampler and last_batch")
        if pin_memory and not torch.cuda.is_available():
            raise MXNetError("DataLoader(pin_memory=True): page-locked "
                             "memory needs a CUDA device")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = max(0, num_workers)
        self._pin_memory = pin_memory
        self._prefetch = max(2, prefetch or 2 * max(self._num_workers, 1))
        self._thread_pool = thread_pool

    def __len__(self):
        return len(self._batch_sampler)

    def _make_batch(self, indices):
        return self._batchify_fn([self._dataset[int(i)] for i in indices])

    def __iter__(self):
        batches = self._batches()
        if not self._pin_memory:
            return batches
        return (_pin(b) for b in batches)

    def _batches(self):
        if self._num_workers == 0:
            return (self._make_batch(indices)
                    for indices in self._batch_sampler)
        if not self._thread_pool:
            if self._batchify_fn is not default_batchify_fn:
                warnings.warn("DataLoader: custom batchify_fn cannot run "
                              "in worker processes; falling back to "
                              "threads")
            elif self._dataset.raw_item(0) is None:
                warnings.warn("DataLoader: dataset has no raw (host-only) "
                              "item path; falling back to threads")
            else:
                return self._process_iter()
        return self._threaded_iter()

    def _process_iter(self):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        idx_q = ctx.Queue()
        out_q = ctx.Queue()
        jobs = [(i, np.asarray(ix))
                for i, ix in enumerate(self._batch_sampler)]
        n_batches = len(jobs)
        # at most `prefetch` batches in flight: a worker gets a new job
        # only when the main process takes a result, so unconsumed
        # segments cannot fill /dev/shm
        in_flight = min(self._prefetch, n_batches)
        for job in jobs[:in_flight]:
            idx_q.put(job)
        feed_next = in_flight
        source = self._dataset._raw_view()
        procs = [ctx.Process(target=_proc_worker,
                             args=(source, idx_q, out_q), daemon=True)
                 for _ in range(self._num_workers)]
        for p in procs:
            p.start()
        pending = {}

        def _drain_pending():
            """Unlink every produced but unconsumed batch: those waiting
            for their turn and those still in out_q."""
            while True:
                try:
                    seq, desc, err = out_q.get_nowait()
                except _queue.Empty:
                    break
                if err is None:
                    pending[seq] = desc
            for desc in pending.values():
                try:
                    _numpy_from_shm(desc)
                except FileNotFoundError:
                    pass
            pending.clear()

        def _wrap(desc):
            tree = _numpy_from_shm(desc)
            if isinstance(tree, list):
                return [_host_array(a) for a in tree]
            return _host_array(tree)

        try:
            next_seq = 0
            received = 0
            empty_strikes = 0
            while received < n_batches:
                try:
                    seq, desc, err = out_q.get(timeout=5.0)
                except _queue.Empty:
                    # a dead worker that held a job never posts it: raise
                    # after sustained silence instead of waiting forever
                    empty_strikes += 1
                    if empty_strikes >= 3 and \
                            any(not p.is_alive() for p in procs):
                        raise MXNetError(
                            "DataLoader worker process died without "
                            "reporting a result (killed/OOM?)")
                    continue
                empty_strikes = 0
                if err is not None:
                    raise MXNetError("DataLoader worker failed: %s" % err)
                received += 1
                if feed_next < n_batches:
                    idx_q.put(jobs[feed_next])
                    feed_next += 1
                pending[seq] = desc
                while next_seq in pending:
                    yield _wrap(pending.pop(next_seq))
                    next_seq += 1
        finally:
            for _ in procs:
                idx_q.put(None)
            # let the workers flush results in transit, reclaim every
            # unconsumed segment, then stop them
            for p in procs:
                p.join(timeout=0.5)
            _drain_pending()
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=5)

    def _threaded_iter(self):
        out_q = _queue.Queue(maxsize=self._prefetch)
        idx_q = _queue.Queue()
        n_batches = 0
        for indices in self._batch_sampler:
            idx_q.put((n_batches, indices))
            n_batches += 1
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    seq, indices = idx_q.get_nowait()
                except _queue.Empty:
                    return
                try:
                    out_q.put((seq, self._make_batch(indices), None))
                except Exception as e:  # surface worker errors
                    out_q.put((seq, None, e))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self._num_workers)]
        for t in threads:
            t.start()
        try:
            next_seq = 0
            pending = {}
            for _ in range(n_batches):
                seq, batch, err = out_q.get()
                if err is not None:
                    raise err
                pending[seq] = batch
                while next_seq in pending:
                    yield pending.pop(next_seq)
                    next_seq += 1
        finally:
            # an early exit: stop handing out work and unblock the
            # threads waiting on a full queue
            stop.set()
            while any(t.is_alive() for t in threads):
                try:
                    while True:
                        out_q.get_nowait()
                except _queue.Empty:
                    pass
                for t in threads:
                    t.join(timeout=0.05)
