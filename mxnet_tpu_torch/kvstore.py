"""KVStore: the parameter-synchronisation facade.

Counterpart of ``mxnet_tpu/kvstore.py`` (parity: reference
``python/mxnet/kvstore.py``). The in-process types ``local``, ``device``,
``nccl``, ``local_allreduce_cpu`` and ``local_allreduce_device`` share
one implementation, as in the JAX package: ``init`` keeps a copy of each
value, ``push`` sums a key's per-device shard list (one shard on one
device: the shard itself, no copy and no added zero) and either applies
the updater to the store's copy (``set_optimizer``; a key list goes
through ``update_batch`` in one call) or stores the sum, and ``pull``
copies the stored value into every out array.

The ``dist*`` types (``dist``, ``dist_sync``, ``dist_sync_device``,
``dist_device_sync``, ``dist_async``) add the worker processes of a
launched job (``launch.py``, ``dist.py``): ``rank``/``num_workers`` come
from ``torch.distributed``; ``init`` seeds every worker with rank 0's
value (one broadcast per new key; ``MXNET_KVSTORE_DIST_BROADCAST_INIT=0``
opts out); a push of a key list sums the locally merged values over the
workers in one batched collective (every key flattened into one bucket
per dtype), after the push-discipline check (every worker must push the
same keys, shapes and dtypes in the same order; ``MXNET_KVSTORE_CHECK_PUSH=0``
skips it, on every worker alike). With gradient compression the wire
carries the 2-bit words (one all-gather, then dequantise and sum) or
fp16 values (one all-gather, summed in fp32). ``dist_async`` runs
synchronously, as the JAX package defines it (exact asynchronous SGD has
no counterpart in one program over all workers). ``wire_bytes_last_push``
and ``_raw`` count this worker's payload and its uncompressed size.

Elastic membership (``heartbeat.py``, ``dist.py``): a dist store starts
this worker's heartbeat when ``MXTPU_HEARTBEAT_DIR`` is set, and crosses
its pre-collective gate (channel ``kv``) before each collective it
issues: ``init``'s broadcast (once per call with new keys), a push's
exchange and ``barrier``. A dead peer then raises
``heartbeat.DeadWorkerError`` instead of hanging. ``live_ranks`` is the
membership (every launched rank until ``_remesh`` drops the dead),
``num_workers`` its size, and ``num_dead_node`` counts its members whose
heartbeat is stale.

Row-sparse values (``mx.nd.sparse``): a push of row_sparse shards sums
them with ``sparse.add_n`` and never densifies; a shard list mixing
storage types is summed dense (a logged storage fallback); compression
refuses sparse values. Across workers each worker's rows travel padded
to a power-of-two bucket (at least 8, the index -1 as padding) after one
all-gather of the row counts, and the union of the rows any worker
touched is summed in rank order, a row whose sum is zero included, so
the store's optimizer still sees it. ``row_sparse_pull`` copies only the
requested rows of a dense or row_sparse value.
"""
from __future__ import annotations

import hashlib
import os

import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray
from . import telemetry
from . import faults

__all__ = ["KVStore", "create"]


class KVStore:
    """(parity: kvstore.KVStore)"""

    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._compression_params = None
        self._compression = None
        # this worker's payload of the last dist push and its
        # uncompressed size: wire/raw is the live compression ratio
        self.wire_bytes_last_push = 0
        self.wire_bytes_last_push_raw = 0
        # elastic membership: None = every live rank of the job; a tuple
        # once _remesh() adopted the survivors
        self._live_ranks = None
        self._gate = None
        if self._is_dist:
            # liveness (parity: ps-lite scheduler heartbeats behind
            # get_num_dead_node, kvstore.h:338); a no-op without a
            # heartbeat directory
            from . import heartbeat
            heartbeat.start_heartbeat(self.rank)

    @property
    def _is_dist(self):
        return self.type.startswith("dist")

    # -- identity ----------------------------------------------------------
    @property
    def rank(self):
        if self._is_dist:
            from . import dist
            return dist.rank()
        return 0

    @property
    def num_workers(self):
        """Workers of the store's membership (the survivors after a
        re-mesh)."""
        return len(self.live_ranks)

    @property
    def live_ranks(self):
        """The store's membership: every live rank of the job until
        :meth:`_remesh` adopts the survivors ((0,) off the dist types)."""
        if self._live_ranks is not None:
            return self._live_ranks
        if self._is_dist:
            from . import dist
            return dist.live_ranks()
        return (0,)

    def _remesh(self, live_ranks):
        """Adopt the surviving membership after a member loss: the worker
        count and the pre-collective gate rebuild over it (the
        collectives already take ``dist.live_group``)."""
        self._live_ranks = tuple(sorted(int(r) for r in live_ranks))
        self._gate = None

    def _collective_gate(self):
        """The pre-collective liveness gate of the store's collectives
        (channel ``kv``; lazy, rebuilt on re-mesh)."""
        if self._gate is None:
            from . import heartbeat
            self._gate = heartbeat.CollectiveGate(
                self.rank, self.live_ranks, channel="kv")
        return self._gate

    def _spans_workers(self):
        from . import dist
        return self._is_dist and dist.initialized() \
            and len(self.live_ranks) > 1

    @property
    def fused_step_subsumable(self):
        """True when a fused train step may run this store's update
        itself: the in-process types, uncompressed (push/pull within one
        process moves nothing; ``Module``'s fused step then keeps the
        store's copies equal to the module's weights)."""
        return not self._is_dist and self._compression is None

    @property
    def fused_dist_step(self):
        """True when ``Module``'s fused step may span the workers for
        this store: the synchronous ``dist*`` types, uncompressed (the
        step all-reduces the gradients in one bucketed collective and
        runs the store's update). ``dist_async`` and compressed stores
        keep the explicit push (phase-split, fallback code
        ``kvstore_dist``)."""
        return (self._is_dist and self.type != "dist_async"
                and self._compression is None)

    # -- core ops ----------------------------------------------------------
    def init(self, key, value):
        """(parity: kvstore.init) one key or a list of keys; a key that
        is already stored keeps its value. In a dist store of several
        workers rank 0's value seeds every worker (one broadcast per new
        key; all workers must call init alike)."""
        from . import dist
        keys, values = _key_value(key, value)
        # never after a member loss: the survivors' values came from the
        # same checkpoint restore and are equal already
        broadcast = self._spans_workers() and not dist.dead_ranks() \
            and os.environ.get("MXNET_KVSTORE_DIST_BROADCAST_INIT",
                               "1") != "0"
        if broadcast and any(k not in self._store for k in keys):
            # a peer that died before this call's broadcast raises here
            self._collective_gate().arrive_and_wait()
        for k, v in zip(keys, values):
            if k in self._store:
                continue
            if broadcast and isinstance(v, NDArray) \
                    and v.stype == "default":
                from .parallel import collectives
                self._store[k] = NDArray(collectives.broadcast(v._data),
                                         v.context)
                continue
            self._store[k] = v.copy() if isinstance(v, NDArray) else v

    def push(self, key, value, priority=0):
        """(parity: kvstore.push) a list value is the key's per-device
        shard list, summed; a key list is one batched push (one
        collective over the workers of a dist store), updated through
        ``update_batch`` when the updater has one. The ``kv_push`` fault
        site fires first: a raise is a lost push; ``nan`` corrupts the
        pushed gradients in place."""
        if faults.active() and faults.fire("kv_push") == "nan":
            flat = value if isinstance(value, (list, tuple)) else [value]
            for v in flat:
                for x in (v if isinstance(v, (list, tuple)) else [v]):
                    if isinstance(x, NDArray):
                        x[:] = faults.poison([x.asnumpy()])[0]
        with telemetry.span("kv_push"):
            self._push_impl(key, value)
        telemetry.counter_inc("kvstore.push")
        if self.wire_bytes_last_push:
            telemetry.counter_inc("kvstore.wire_bytes",
                                  self.wire_bytes_last_push)
            telemetry.counter_inc("kvstore.dist.collectives")
            telemetry.counter_inc("kvstore.dist.wire_bytes",
                                  self.wire_bytes_last_push)
            telemetry.counter_inc("kvstore.dist.wire_bytes_raw",
                                  self.wire_bytes_last_push_raw)

    def _push_impl(self, key, value):
        keys, values = _key_value(key, value, allow_list_value=True)
        merged_list = []
        for k, vlist in zip(keys, values):
            if not isinstance(vlist, (list, tuple)):
                vlist = [vlist]
            if self._compression is not None and not self._is_dist:
                # one process: each device shard goes through the wire
                # format with its own residual; a dist store compresses
                # the locally merged value toward the other workers
                vlist = [self._compress_shard(k, i, v)
                         for i, v in enumerate(vlist)]
            elif self._compression is not None:
                for v in vlist:
                    _reject_sparse_compression(v)
            merged_list.append(_merge_shards(vlist))
        merged_list = self._global_reduce_batch(keys, merged_list)
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

    def _global_reduce_batch(self, keys, merged_list):
        """dist*: sum every locally merged value over the workers in one
        collective per dtype (parity: the ps-lite server aggregating
        every worker's push, and the JAX package's one jitted exchange).
        One worker with compression still quantises toward the wire, as
        the JAX package does. Returns NDArrays on each value's context;
        sets ``wire_bytes_last_push``/``_raw``."""
        self.wire_bytes_last_push = 0
        self.wire_bytes_last_push_raw = 0
        if not self._is_dist or not merged_list:
            return merged_list
        if not self._spans_workers():
            if self._compression is not None:
                merged_list = [self._compress_shard(k, "dist", m)
                               for k, m in zip(keys, merged_list)]
            return merged_list
        from .ndarray import sparse as _sp
        from .parallel import collectives
        gate = self._collective_gate()
        # the discipline check's all-gather is the first collective
        gate.arrive_and_wait()
        t_wire = collectives.wire["seconds"]
        self._assert_push_discipline(keys, merged_list)
        comp = self._compression
        if any(isinstance(m, _sp.BaseSparseNDArray) for m in merged_list):
            result = self._sparse_exchange(merged_list)
            gate.note_wait((collectives.wire["seconds"] - t_wire) * 1e3)
            return result
        raw = [m._data for m in merged_list]
        if comp is None:
            outs = bucketed_all_reduce(raw)
            self.wire_bytes_last_push = sum(t.numel() * t.element_size()
                                            for t in raw)
            self.wire_bytes_last_push_raw = self.wire_bytes_last_push
        else:
            outs = self._compressed_exchange(keys, raw)
        # time in the collectives is waiting on peers, not this rank's
        # own work (the gate's straggler self-time)
        gate.note_wait((collectives.wire["seconds"] - t_wire) * 1e3)
        return [NDArray(o, m.context) for o, m in zip(outs, merged_list)]

    @staticmethod
    def _row_bucket(n):
        """A row count padded to a power of two, at least 8 (parity: the
        JAX package's exchange, which compiles once per bucket)."""
        return max(8, 1 << (max(int(n), 1) - 1).bit_length())

    def _sparse_exchange(self, merged_list):
        """A push holding sparse values: the dense values (and each csr
        value's dense view, cast back to csr) summed in one bucketed
        all-reduce a dtype; each row_sparse value's rows all-gathered,
        padded to the bucket of the largest count, and their union summed
        in rank order. ``wire_bytes_last_push`` counts what travels: a
        dense value's bytes, and per row_sparse value the bucket's int32
        ids and rows (the JAX package's formula)."""
        from .parallel import collectives
        from .ndarray import sparse as _sp
        rsp = [i for i, m in enumerate(merged_list)
               if isinstance(m, _sp.RowSparseNDArray)]
        dense = [i for i in range(len(merged_list)) if i not in rsp]
        out = [None] * len(merged_list)
        wire = 0
        if dense:
            raw = [merged_list[i]._data for i in dense]
            wire += sum(t.numel() * t.element_size() for t in raw)
            for i, o in zip(dense, bucketed_all_reduce(raw)):
                m = merged_list[i]
                out[i] = NDArray(o, m.context)
                if isinstance(m, _sp.CSRNDArray):
                    out[i] = _sp.cast_storage(out[i], "csr")
        if rsp:
            first = merged_list[rsp[0]]._rsp_data
            counts = torch.tensor([merged_list[i]._rsp_indices.numel()
                                   for i in rsp], dtype=torch.int32,
                                  device=first.device)
            all_counts = collectives.all_gather(counts, tiled=False).cpu()
            for j, i in enumerate(rsp):
                m = merged_list[i]
                n = int(m._rsp_indices.numel())
                pad = self._row_bucket(int(all_counts[:, j].max()))
                width = tuple(m.shape[1:])
                ids = torch.full((pad,), -1, dtype=torch.int32,
                                 device=m._rsp_data.device)
                ids[:n] = m._rsp_indices
                rows = torch.zeros((pad,) + width, dtype=m._rsp_data.dtype,
                                   device=m._rsp_data.device)
                rows[:n] = m._rsp_data
                g_ids = collectives.all_gather(ids, tiled=False)
                g_rows = collectives.all_gather(rows, tiled=False)
                parts = [(g_ids[r, :int(c)], g_rows[r, :int(c)])
                         for r, c in enumerate(all_counts[:, j].tolist())]
                uniq, summed = _sp._union_sum(parts, width, rows.dtype,
                                              rows.device)
                out[i] = _sp.RowSparseNDArray(summed, uniq, m.shape,
                                              m.context)
                wire += ids.numel() * ids.element_size() \
                    + rows.numel() * rows.element_size()
        self.wire_bytes_last_push = wire
        self.wire_bytes_last_push_raw = wire
        return out

    def _compressed_exchange(self, keys, raw):
        """The compressed wire: every key's payload (2-bit words, or
        fp16 values) in one buffer, one all-gather, then each worker's
        part dequantised and summed in fp32 in rank order."""
        from .parallel import collectives
        comp = self._compression
        payloads = [comp.compress(("dist", k), t).reshape(-1)
                    for k, t in zip(keys, raw)]
        if comp.type == "2bit":
            payloads = [p.view(torch.int32) for p in payloads]
        sizes = [p.numel() for p in payloads]
        gathered = collectives.all_gather(torch.cat(payloads), tiled=False)
        outs = []
        start = 0
        for t, n in zip(raw, sizes):
            total = torch.zeros(t.shape, dtype=torch.float32,
                                device=t.device)
            for part in gathered:
                total += comp.decompress(part[start:start + n], t.shape)
            outs.append(total.to(t.dtype))
            start += n
        self.wire_bytes_last_push = sum(p.numel() * p.element_size()
                                        for p in payloads)
        self.wire_bytes_last_push_raw = sum(t.numel() * 4 for t in raw)
        return outs

    def _assert_push_discipline(self, keys, merged_list):
        """Every worker must push the same (keys, shapes, dtypes) in the
        same order: a mismatch would mis-sum or hang the batched
        collective, so the signature's hash is all-gathered and compared
        first (16 bytes per worker). ``MXNET_KVSTORE_CHECK_PUSH=0``
        skips it; set it on every worker alike (the check is itself a
        collective)."""
        if os.environ.get("MXNET_KVSTORE_CHECK_PUSH", "1") == "0":
            return
        from .parallel import collectives
        desc = repr([(str(k), m.stype, tuple(m.shape), str(m.dtype))
                     for k, m in zip(keys, merged_list)])
        h = torch.frombuffer(bytearray(hashlib.sha256(desc.encode())
                                       .digest()[:16]), dtype=torch.int32)
        all_h = collectives.all_gather(h, tiled=False)
        if not bool((all_h == all_h[0]).all()):
            raise MXNetError(
                "kvstore dist push discipline violated: workers pushed "
                "different (keys, storage types, shapes, dtypes) in this "
                "batched push. Every worker must push the same keys in "
                "the same order. Local push signature: " + desc)

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
        """(parity: kvstore.row_sparse_pull) only the rows ``row_ids``
        names of each key's value (dense or row_sparse), as a row_sparse
        ``out`` or into a dense ``out``'s dense view; a row of the value
        that is all zero is not stored. ``row_ids`` not a list or tuple
        serves every key."""
        if out is None or row_ids is None:
            raise MXNetError("row_sparse_pull requires out= and row_ids=")
        from .ndarray import sparse as _sp
        telemetry.counter_inc("kvstore.pull")
        with telemetry.span("kv_pull"):
            keys, outs = _key_value(key, out, allow_list_value=True)
            if not isinstance(row_ids, (list, tuple)):
                row_ids = [row_ids] * len(keys)
            for k, olist, rids in zip(keys, outs, row_ids):
                if k not in self._store:
                    raise MXNetError("row_sparse_pull: key %r was not "
                                     "init()ed" % (k,))
                src = self._store[k]
                picked = src.retain(rids) \
                    if isinstance(src, _sp.RowSparseNDArray) \
                    else _dense_rows(src, rids)
                for o in (olist if isinstance(olist, (list, tuple))
                          else [olist]):
                    if isinstance(o, _sp.RowSparseNDArray):
                        o._take(picked._moved(o.context))
                    else:
                        o._assign(NDArray(picked._data.to(o._data.device),
                                          o.context))

    def barrier(self):
        """Block until every live worker of a dist store gets here
        (parity: KVStore::Barrier), gated like every collective; nothing
        to wait for otherwise."""
        if self._spans_workers():
            from .parallel import collectives
            self._collective_gate().arrive_and_wait()
            collectives.barrier()

    def send_command_to_servers(self, head, body):
        pass

    def num_dead_node(self, node_id=0, timeout=None):
        """Members of a dist store whose heartbeat is missing or stale
        (parity: KVStore::get_num_dead_node, kvstore.h:338; ``node_id``
        is accepted for the reference's signature, the directory covers
        every worker). Members a re-mesh dropped no longer count; 0 off
        the dist types or without a heartbeat directory."""
        if not self._is_dist:
            return 0
        from . import heartbeat
        return len(heartbeat.stale_ranks(self.live_ranks, timeout=timeout))

    # -- optimizer plumbing ------------------------------------------------
    def set_optimizer(self, optimizer):
        """Run the optimizer inside the store (``update_on_kvstore``;
        every worker of a dist store runs it on the summed gradients)."""
        from . import optimizer as opt
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def _set_updater(self, updater):
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        """(parity: kvstore.set_gradient_compression) ``{'type': '2bit',
        'threshold': t}`` or ``{'type': 'fp16'}``; in-process stores
        quantise each device shard, dist stores the wire."""
        from .gradient_compression import GradientCompression
        params = dict(compression_params or {})
        ctype = params.pop("type", "2bit")
        self._compression_params = compression_params
        self._compression = GradientCompression(type=ctype, **params)

    def _compress_shard(self, key, shard_idx, v):
        """Round-trip one shard through the wire format."""
        _reject_sparse_compression(v)
        raw = v._data
        packed = self._compression.compress((key, shard_idx), raw)
        return NDArray(self._compression.decompress(packed, raw.shape,
                                                    raw.dtype), v.context)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """The updater's states in the JAX package's pickled format (with
        the optimizer beside them under ``dump_optimizer``), written
        atomically."""
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        from .checkpoint import atomic_write
        atomic_write(fname, self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        """States written by either package's ``save_optimizer_states``;
        a dumped optimizer's update counts and scheduler position are
        adopted."""
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())


def bucketed_all_reduce(tensors, group=None):
    """The sum over the workers of every tensor in one collective per
    dtype: each dtype's tensors are flattened into one bucket, reduced,
    and split back (new tensors, shapes and devices of the inputs; the
    bucket lives on the first tensor's device)."""
    from .parallel import collectives
    out = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        dev = tensors[idx[0]].device
        flat = torch.cat([tensors[i].reshape(-1).to(dev) for i in idx])
        total = collectives.all_reduce(flat, group)
        start = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = total[start:start + n].reshape(tensors[i].shape) \
                .to(tensors[i].device)
            start += n
    return out


def _merge_shards(vlist):
    """The sum of one key's shards: row_sparse shards through
    ``sparse.add_n`` (never densified), a list mixing storage types dense
    (the logged storage fallback), dense shards as they are."""
    from .ndarray import sparse as _sp
    if all(isinstance(v, _sp.RowSparseNDArray) for v in vlist):
        return _sp.add_n(list(vlist)) if len(vlist) > 1 else vlist[0]
    if any(isinstance(v, _sp.BaseSparseNDArray) for v in vlist):
        from .config import storage_fallback_log
        storage_fallback_log("kvstore push of [%s] shards"
                             % ", ".join(v.stype for v in vlist))
        vlist = [NDArray(v._data, v.context)
                 if isinstance(v, _sp.BaseSparseNDArray) else v
                 for v in vlist]
    merged = vlist[0]
    if len(vlist) > 1:
        merged = vlist[0].copy()
        for v in vlist[1:]:
            merged += v.as_in_context(merged.context)
    return merged


def _reject_sparse_compression(v):
    from .ndarray.sparse import BaseSparseNDArray
    if isinstance(v, BaseSparseNDArray):
        # the reference's dist store refuses compression for sparse
        # storage rather than densifying it
        raise MXNetError(
            "gradient compression is not supported for sparse "
            "gradients (reference parity); push dense or disable "
            "set_gradient_compression")


def _dense_rows(src, row_ids):
    """The rows ``row_ids`` of a dense value as a row_sparse array: the
    ids in range, sorted and unique, with an all-zero row left out (the
    JAX package's ``cast_storage(src, "row_sparse").retain(row_ids)``,
    without scanning the whole value)."""
    from .ndarray import sparse as _sp
    dense = src._data
    r = _sp._index_tensor(row_ids, dense.device).long()
    r = torch.unique(r[(r >= 0) & (r < dense.shape[0])])
    rows = dense.index_select(0, r)
    nz = rows != 0
    if rows.ndim > 1:
        nz = nz.flatten(1).any(1)
    return _sp.RowSparseNDArray(rows[nz], r[nz], tuple(dense.shape),
                                src.context)


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
    """(parity: mx.kvstore.create) a store by type name."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name not in _VALID:
        raise MXNetError("unknown kvstore type %r (valid: %s)"
                         % (name, _VALID))
    return KVStore(name)
