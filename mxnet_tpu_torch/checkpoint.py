"""Preemption-safe checkpoints: atomic writes, keep-last-K rotation,
signal-armed saves and exact training resume.

A copy of ``mxnet_tpu/checkpoint.py:60-377``:

* ``atomic_write`` / ``atomic_save_ndarrays``: temp file in the same
  directory, fsync, rename, so a crash at any instant leaves either the
  old complete file or the new one (local paths only: the port has no
  ``filesystem`` module for remote URIs);
* ``CheckpointManager(prefix, keep_last)``: ``save`` writes
  ``prefix-NNNN.params``, ``prefix-symbol.json``, ``prefix-NNNN.states``
  and ``prefix-NNNN.meta.json`` (the JAX package's names, ``NNNN`` the
  resume epoch), ``latest``/``load``/``restore`` read them back (the
  parameters, the optimizer states with their update counts, the
  random generators), ``prune`` keeps the newest ``keep_last``;
* ``arm_signals``: SIGTERM/SIGINT set a flag ``Module.fit`` polls at
  batch boundaries, which saves mid-epoch and raises
  ``TrainingPreempted``; ``disarm_signals`` restores the handlers that
  were in force.

The meta record is the JAX package's, but the random state: the JAX
package keeps its global key under ``rng_state``, the port each device
generator's state (``random.get_state``) under ``torch_rng_state``. Each
package restores its own key and ignores the other's, so a checkpoint of
either resumes in the other (random draws never match across packages).
A module on a mesh saves its whole parameters and states (gathered from
the members) with ``meta["layout"]``, its ``partition_summary()``; a
restore cuts the resuming module's shards, whatever mesh (or single
device) it is bound to.
"""
from __future__ import annotations

import json
import os
import re
import signal as _signal
import threading
import time

from .base import MXNetError
from . import telemetry

__all__ = ["CheckpointManager", "TrainingPreempted", "DivergenceError",
           "atomic_write", "atomic_save_ndarrays"]


class TrainingPreempted(MXNetError):
    """``Module.fit`` was interrupted by an armed signal (or
    ``request_preempt``) and saved a resumable checkpoint: ``epoch`` and
    ``nbatch`` name the resume point, ``prefix`` the checkpoint."""

    def __init__(self, message, epoch=None, nbatch=None, prefix=None):
        super().__init__(message)
        self.epoch = epoch
        self.nbatch = nbatch
        self.prefix = prefix


class DivergenceError(MXNetError):
    """The divergence sentinel found non-finite values and the policy is
    ``halt`` (or ``rollback`` with nothing to roll back to)."""


def _fsync_path(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _tmp_beside(path):
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, ".%s.tmp.%d" % (os.path.basename(path),
                                           os.getpid()))


def atomic_write(path, data):
    """Write ``data`` (bytes or str) to ``path`` atomically: temp file
    in the same directory, fsync, rename. A crash at ANY instant leaves
    either the old complete file or the new complete file."""
    if isinstance(data, str):
        data = data.encode()
    tmp = _tmp_beside(path)
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_save_ndarrays(path, save_dict):
    """``nd.save`` semantics with the temp+fsync+rename discipline."""
    from .ndarray import save as _nd_save
    tmp = _tmp_beside(path)
    try:
        _nd_save(tmp, save_dict)
        _fsync_path(tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class CheckpointManager:
    """Keep-last-K atomic checkpoints over ``prefix`` and the preemption
    flag ``Module.fit`` polls at batch boundaries (parity:
    mxnet_tpu/checkpoint.py:145-377)::

        mgr = mx.CheckpointManager("ckpt/fcn", keep_last=2)
        mod.fit(train, num_epoch=2, checkpoint=mgr)     # SIGTERM-safe
        mod.fit(train, num_epoch=2, checkpoint=mgr, resume=True)
    """

    def __init__(self, prefix, keep_last=3):
        self.prefix = str(prefix)
        self.keep_last = max(1, int(keep_last))
        # written by the signal handler: a single store polled at batch
        # boundaries, no lock (a handler that locks can deadlock)
        self._preempt = None
        self._armed = {}                # guarded by: self._lock
        self._lock = threading.Lock()

    def _meta_path(self, epoch):
        return "%s-%04d.meta.json" % (self.prefix, epoch)

    def _states_path(self, epoch):
        return "%s-%04d.states" % (self.prefix, epoch)

    def _params_path(self, epoch):
        return "%s-%04d.params" % (self.prefix, epoch)

    def save(self, module, epoch, nbatch=0, save_optimizer_states=True):
        """One atomic checkpoint of ``module`` at resume point ``(epoch,
        nbatch)``: parameters, symbol, optimizer states (when
        initialised), the generators and the meta record; then prune.
        Returns the meta dict."""
        from . import random as _random
        epoch, nbatch = int(epoch), int(nbatch)
        arg_params, aux_params = module.get_params()
        if module.symbol is not None:
            atomic_write("%s-symbol.json" % self.prefix,
                         module.symbol.tojson())
        blob = {("arg:%s" % k): v for k, v in arg_params.items()}
        blob.update({("aux:%s" % k): v for k, v in aux_params.items()})
        atomic_save_ndarrays(self._params_path(epoch), blob)
        has_states = bool(save_optimizer_states
                          and getattr(module, "optimizer_initialized",
                                      False))
        if has_states:
            module.save_optimizer_states(self._states_path(epoch))
        meta = {"epoch": epoch, "nbatch": nbatch, "param_epoch": epoch,
                "prefix": os.path.abspath(self.prefix),
                "torch_rng_state": _random.get_state(),
                "optimizer_states": has_states, "ts": time.time()}
        # the params file holds the whole values (gathered from a mesh's
        # members); the layout they were trained under is provenance: a
        # restore cuts the resuming module's own shards
        layout = getattr(module, "partition_summary", None)
        layout = layout() if callable(layout) else None
        if layout:
            meta["layout"] = layout
        optimizer = getattr(module, "_optimizer", None)
        if optimizer is not None:
            meta["update_counts"] = {
                str(k): int(v)
                for k, v in optimizer._index_update_count.items()}
            meta["num_update"] = int(optimizer.num_update)
        atomic_write(self._meta_path(epoch), json.dumps(meta,
                                                        sort_keys=True))
        self.prune()
        telemetry.counter_inc("checkpoint.save")
        telemetry.record_event("checkpoint.save", epoch=epoch,
                               nbatch=nbatch)
        return meta

    def epochs(self):
        """Sorted epochs with a meta record on disk (a regex over the
        directory: ``%04d`` widens past 9999, and the prefix may hold
        glob characters)."""
        prefix = os.path.abspath(self.prefix)
        d = os.path.dirname(prefix) or "."
        pat = re.compile(re.escape(os.path.basename(prefix))
                         + r"-(\d{4,})\.meta\.json$")
        try:
            names = os.listdir(d)
        except OSError:
            return []
        return sorted(int(m.group(1)) for m in map(pat.match, names) if m)

    def latest(self):
        """The newest readable meta record, or None (a fresh start); an
        unreadable one is passed over for the next newest."""
        for epoch in reversed(self.epochs()):
            try:
                with open(self._meta_path(epoch)) as f:
                    meta = json.load(f)
                if isinstance(meta, dict) and "epoch" in meta:
                    return meta
            except (OSError, ValueError):
                continue
        return None

    def load(self, meta=None, ctx=None):
        """``(symbol, arg_params, aux_params, meta)`` of ``meta``
        (default ``latest()``); raises when there is none."""
        from .model import load_checkpoint
        from .context import cpu
        if meta is None:
            meta = self.latest()
        if meta is None:
            raise MXNetError("checkpoint: no checkpoint under prefix %r"
                             % self.prefix)
        sym, arg_params, aux_params = load_checkpoint(
            self.prefix, int(meta["param_epoch"]), ctx=ctx or cpu())
        return sym, arg_params, aux_params, meta

    def restore(self, module, meta=None):
        """Put a checkpoint back into a bound module: parameters,
        optimizer states and update counts (when both sides have them)
        and this package's generators. Returns the meta used."""
        from . import random as _random
        _, arg_params, aux_params, meta = self.load(meta)
        module.set_params(arg_params, aux_params)
        if meta.get("optimizer_states") \
                and getattr(module, "optimizer_initialized", False):
            states = self._states_path(int(meta["param_epoch"]))
            if os.path.exists(states):
                module.load_optimizer_states(states)
        optimizer = getattr(module, "_optimizer", None)
        if optimizer is not None and meta.get("update_counts"):
            optimizer._index_update_count = {
                int(k): int(v) for k, v in meta["update_counts"].items()}
            optimizer.num_update = int(meta.get("num_update",
                                                optimizer.num_update))
        if meta.get("torch_rng_state"):
            _random.set_state(meta["torch_rng_state"])
        telemetry.counter_inc("checkpoint.resume")
        telemetry.record_event("checkpoint.resume", epoch=int(meta["epoch"]),
                               nbatch=int(meta.get("nbatch", 0)))
        return meta

    def prune(self):
        """Drop all but the newest ``keep_last`` epochs' files (the
        shared ``-symbol.json`` stays)."""
        for epoch in self.epochs()[:-self.keep_last]:
            for path in (self._params_path(epoch), self._states_path(epoch),
                         self._meta_path(epoch)):
                try:
                    os.unlink(path)
                except OSError:
                    pass

    @property
    def preempt_requested(self):
        """The name of the signal that asked for preemption, or None."""
        return self._preempt

    def request_preempt(self, source="manual"):
        """Set the preemption flag, as the armed handler does."""
        self._preempt = str(source)

    def clear_preempt(self):
        self._preempt = None

    def arm_signals(self, signals=(_signal.SIGTERM, _signal.SIGINT)):
        """Handlers that turn ``signals`` into the preemption flag; off
        the main thread a no-op (``request_preempt`` still works).
        ``disarm_signals`` restores the handlers in force before."""
        with self._lock:
            for sig in signals:
                if sig in self._armed:
                    continue
                try:
                    prev = _signal.signal(
                        sig, lambda signum, frame: self.request_preempt(
                            _signal.Signals(signum).name))
                except ValueError:      # not the main thread
                    return self
                self._armed[sig] = prev
        return self

    def disarm_signals(self):
        with self._lock:
            for sig, prev in self._armed.items():
                try:
                    _signal.signal(sig, prev)
                except (ValueError, TypeError):
                    pass
            self._armed.clear()
        return self
