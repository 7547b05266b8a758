"""KVStore: the parameter-synchronisation facade of one process.

Counterpart of ``mxnet_tpu/kvstore.py`` (parity: reference
``python/mxnet/kvstore.py``). The in-process types ``local``, ``device``,
``nccl``, ``local_allreduce_cpu`` and ``local_allreduce_device`` share
one implementation, as in the JAX package: ``init`` keeps a copy of each
value, ``push`` sums a key's per-device shard list (one shard on one
device: the shard itself, no copy and no added zero) and either applies
the updater to the store's copy (``set_optimizer``; a key list goes
through ``update_batch`` in one call) or stores the sum, and ``pull``
copies the stored value into every out array. ``rank`` is 0,
``num_workers`` 1 and ``barrier`` does nothing.

Not ported yet: the ``dist*`` types and gradient compression (ROADMAP
Queue 1 item 4) and ``row_sparse_pull`` (sparse storage, item 6); each
raises ``MXNetError`` naming its item.
"""
from __future__ import annotations

import os

from .base import MXNetError
from .ndarray.ndarray import NDArray
from . import telemetry
from . import faults

__all__ = ["KVStore", "create"]

_DIST = "not ported yet (ROADMAP Queue 1 item 4, the distributed slice)"


class KVStore:
    """(parity: kvstore.KVStore) one process, one implementation for every
    in-process type."""

    def __init__(self, kv_type="local"):
        if kv_type.startswith("dist"):
            raise MXNetError("kvstore %r: the dist stores are %s"
                             % (kv_type, _DIST))
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None

    # -- identity ----------------------------------------------------------
    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    @property
    def fused_step_subsumable(self):
        """True: a fused train step may run this store's updater itself,
        since push/pull within one process on one device moves nothing
        (``Module``'s fused step then keeps the store's copies equal to
        the module's weights)."""
        return True

    # -- core ops ----------------------------------------------------------
    def init(self, key, value):
        """(parity: kvstore.init) one key or a list of keys; a key that
        is already stored keeps its value."""
        keys, values = _key_value(key, value)
        for k, v in zip(keys, values):
            if k not in self._store:
                self._store[k] = v.copy() if isinstance(v, NDArray) else v

    def push(self, key, value, priority=0):
        """(parity: kvstore.push) a list value is the key's per-device
        shard list, summed; a key list is one batched push, updated
        through ``update_batch`` when the updater has one. The
        ``kv_push`` fault site fires first: a raise is a lost push;
        ``nan`` corrupts the pushed gradients in place."""
        if faults.active() and faults.fire("kv_push") == "nan":
            flat = value if isinstance(value, (list, tuple)) else [value]
            for v in flat:
                for x in (v if isinstance(v, (list, tuple)) else [v]):
                    if isinstance(x, NDArray):
                        x[:] = faults.poison([x.asnumpy()])[0]
        with telemetry.span("kv_push"):
            self._push_impl(key, value)
        telemetry.counter_inc("kvstore.push")

    def _push_impl(self, key, value):
        keys, values = _key_value(key, value, allow_list_value=True)
        merged_list = []
        for vlist in values:
            if not isinstance(vlist, (list, tuple)):
                vlist = [vlist]
            merged = vlist[0]
            if len(vlist) > 1:
                merged = vlist[0].copy()
                for v in vlist[1:]:
                    merged += v
            merged_list.append(merged)
        if self._updater is not None:
            for k in keys:
                if k not in self._store:
                    raise MXNetError("push: key %r was not init()ed" % (k,))
            if hasattr(self._updater, "update_batch"):
                self._updater.update_batch(
                    [_int_key(k) for k in keys], merged_list,
                    [self._store[k] for k in keys])
            else:
                for k, merged in zip(keys, merged_list):
                    self._updater(_int_key(k), merged, self._store[k])
        else:
            for k, merged in zip(keys, merged_list):
                self._store[k] = merged.copy()

    def pull(self, key, out=None, priority=0, row_ids=None):
        """(parity: kvstore.pull) copy each key's value into its outs."""
        if out is None:
            raise MXNetError("pull requires out=")
        telemetry.counter_inc("kvstore.pull")
        with telemetry.span("kv_pull"):
            keys, outs = _key_value(key, out, allow_list_value=True)
            for k, olist in zip(keys, outs):
                if k not in self._store:
                    raise MXNetError("pull: key %r was not init()ed"
                                     % (k,))
                src = self._store[k]
                for o in (olist if isinstance(olist, (list, tuple))
                          else [olist]):
                    src.copyto(o)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise MXNetError("row_sparse_pull: sparse storage is not ported "
                         "yet (ROADMAP Queue 1 item 6)")

    def barrier(self):
        """Every worker is this one: nothing to wait for."""

    def send_command_to_servers(self, head, body):
        pass

    def num_dead_node(self, node_id=0, timeout=None):
        return 0

    # -- optimizer plumbing ------------------------------------------------
    def set_optimizer(self, optimizer):
        """Run the optimizer inside the store (``update_on_kvstore``)."""
        from . import optimizer as opt
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def _set_updater(self, updater):
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        raise MXNetError("set_gradient_compression: gradient compression "
                         "is %s" % _DIST)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """The updater's states, in the JAX package's pickled format,
        written to a temporary name and renamed into place."""
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        blob = self._updater.get_states(dump_optimizer)
        tmp = "%s.tmp.%d" % (fname, os.getpid())
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, fname)

    def load_optimizer_states(self, fname):
        """States written by either package's ``save_optimizer_states``."""
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())


def _int_key(k):
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


def _key_value(key, value, allow_list_value=False):
    """Keys and values as parallel lists; with ``allow_list_value`` a
    flat value list of n shards per key is grouped key by key."""
    if isinstance(key, (str, int)):
        return [key], [value]
    keys = list(key)
    values = list(value)
    if len(values) != len(keys):
        if allow_list_value and len(values) % len(keys) == 0:
            n = len(values) // len(keys)
            values = [values[i * n:(i + 1) * n] for i in range(len(keys))]
        else:
            raise MXNetError("key/value length mismatch")
    return keys, values


_VALID = ("local", "device", "nccl", "local_allreduce_cpu",
          "local_allreduce_device", "dist", "dist_sync", "dist_async",
          "dist_sync_device", "dist_device_sync")


def create(name="local"):
    """(parity: mx.kvstore.create) a store by type name; the ``dist*``
    names raise until the distributed slice."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name not in _VALID:
        raise MXNetError("unknown kvstore type %r (valid: %s)"
                         % (name, _VALID))
    return KVStore(name)
