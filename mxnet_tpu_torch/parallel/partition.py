"""Partition rules: one declarative layout for the parameters of a mesh.

Counterpart of ``mxnet_tpu/parallel/partition.py``. An ordered list of
``(regex, PartitionSpec)`` pairs is matched against parameter path
names, first match wins, with an explicit UNMATCHED policy (replicate
or error)::

    rules = PartitionRules([
        (r"fc\\d+_weight$", P("mp", None)),   # row-shard linear weights
        (r"fc\\d+_bias$",   P("mp")),
    ])

Semantics, as in the JAX package:

* **first match wins** — rules are tried in order with ``re.search``;
* **scalars never shard** — a 0-d or one-element leaf gets ``P()``;
* **UNMATCHED policy** — ``"replicate"`` (default) maps unmatched names
  to ``P()``, ``"error"`` raises;
* **downgrade** — a matched spec that names an axis the mesh lacks, is
  longer than the tensor's rank, or splits a dimension its axes do not
  divide is placed replicated instead, with one warning per parameter
  and cause and the ``partition.replicated_fallback`` counter.

The placement is the port's own :class:`Placement` (a spec on a mesh),
where the JAX package builds a ``NamedSharding``: ``shard_shape`` and
``device_count`` give the per-device bytes ``spec_nbytes`` charges, and
``spmd.shard_put`` cuts a member's shard by it.
"""
from __future__ import annotations

import math
import re
import threading

from ..base import MXNetError
from .. import telemetry
from .mesh import PartitionSpec as P

__all__ = ["PartitionRules", "UNMATCHED_REPLICATE", "UNMATCHED_ERROR",
           "Placement", "sharding_for", "spec_nbytes", "committed_nbytes",
           "partition_summary"]

UNMATCHED_REPLICATE = "replicate"
UNMATCHED_ERROR = "error"

# once-per-(param, cause) downgrade warnings already sent through log.py
_DOWNGRADE_WARNED = set()          # guarded by: _downgrade_lock
_downgrade_lock = threading.Lock()


def _as_pspec(spec):
    """Normalise one rule's right-hand side to a PartitionSpec."""
    if spec is None:
        return P()
    if isinstance(spec, P):
        return spec
    if isinstance(spec, (tuple, list)):
        return P(*spec)
    if isinstance(spec, str):
        return P(spec)
    raise MXNetError("partition rule spec must be a PartitionSpec, "
                     "axis name, or tuple of axis names, got %r" % (spec,))


class PartitionRules:
    """Ordered ``(pattern, PartitionSpec)`` rule tree.

    ``spec_for(name, shape)`` resolves one parameter; ``apply(params)``
    maps a whole ``{name: array_or_shape}`` tree. Hashable and
    JSON-summarisable (``describe()``).
    """

    __slots__ = ("rules", "unmatched", "_compiled", "_cache", "_lock")

    def __init__(self, rules, unmatched=UNMATCHED_REPLICATE):
        if unmatched not in (UNMATCHED_REPLICATE, UNMATCHED_ERROR):
            raise MXNetError("unmatched policy must be %r or %r, got %r"
                             % (UNMATCHED_REPLICATE, UNMATCHED_ERROR,
                                unmatched))
        norm = []
        for entry in rules:
            try:
                pattern, spec = entry
            except (TypeError, ValueError):
                raise MXNetError("each rule must be a (pattern, spec) "
                                 "pair, got %r" % (entry,))
            norm.append((str(pattern), _as_pspec(spec)))
        self.rules = tuple(norm)
        self.unmatched = unmatched
        self._compiled = tuple(re.compile(p) for p, _ in self.rules)
        self._cache = {}                 # guarded by: self._lock
        self._lock = threading.Lock()

    def _key(self):
        return (self.rules, self.unmatched)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, PartitionRules) \
            and self._key() == other._key()

    def __repr__(self):
        return "PartitionRules(%s, unmatched=%r)" % (
            [(p, tuple(s)) for p, s in self.rules], self.unmatched)

    def describe(self):
        """JSON-safe summary (checkpoint meta / program cards)."""
        return {"rules": [[p, list(s)] for p, s in self.rules],
                "unmatched": self.unmatched}

    def spec_for(self, name, shape=None):
        """The PartitionSpec for one parameter path name. Scalars and
        one-element leaves never shard; otherwise the first rule whose
        pattern ``re.search``-matches ``name`` wins; unmatched names
        follow the policy."""
        shape = None if shape is None else tuple(int(d) for d in shape)
        key = (name, shape)
        with self._lock:
            hit = self._cache.get(key)
        if hit is not None:
            return hit
        if shape is not None and (len(shape) == 0 or math.prod(shape) <= 1):
            spec = P()
        else:
            spec = None
            for rx, (_, ps) in zip(self._compiled, self.rules):
                if rx.search(name) is not None:
                    spec = ps
                    break
            if spec is None:
                if self.unmatched == UNMATCHED_ERROR:
                    raise MXNetError(
                        "partition: no rule matches parameter %r "
                        "(unmatched policy is 'error'; add a rule or "
                        "a catch-all)" % name)
                spec = P()
        with self._lock:
            self._cache[key] = spec
        return spec

    def prepended(self, rules):
        """A new ``PartitionRules`` with ``rules`` tried before this
        set's, same unmatched policy."""
        return PartitionRules(tuple((p, s) for p, s in rules) + self.rules,
                              unmatched=self.unmatched)

    def apply(self, params):
        """{name: PartitionSpec} for a ``{name: array_or_shape}`` tree
        (arrays need only a ``.shape``; plain shape tuples work too)."""
        return {name: self.spec_for(name, getattr(leaf, "shape", leaf))
                for name, leaf in params.items()}


def _entry_axes(entry):
    return () if entry is None else (
        tuple(entry) if isinstance(entry, tuple) else (entry,))


class Placement:
    """A PartitionSpec on a mesh: the port's counterpart of a
    ``NamedSharding``. Dimension ``i`` splits over the axes of
    ``spec[i]`` (row-major when there are several); every other axis
    holds copies."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)

    def __repr__(self):
        return "Placement(%r, %s)" % (self.spec, dict(self.mesh.shape))

    @property
    def device_count(self):
        return self.mesh.size

    @property
    def is_fully_replicated(self):
        return all(not _entry_axes(e) for e in self.spec)

    def split(self, dim):
        """The axes dimension ``dim`` splits over (empty: not split)."""
        return _entry_axes(self.spec[dim]) if dim < len(self.spec) else ()

    def shard_shape(self, shape):
        shape = list(int(d) for d in shape)
        for dim in range(min(len(self.spec), len(shape))):
            n = self.mesh.axis_size(self.split(dim)) if self.split(dim) \
                else 1
            shape[dim] //= n
        return tuple(shape)

    def shard_index(self, dim, coords):
        """The block of dimension ``dim`` held at mesh ``coords``."""
        idx = 0
        for a in self.split(dim):
            idx = idx * self.mesh.shape[a] + coords[a]
        return idx

    def shard(self, x, coords):
        """The block of a whole tensor ``x`` held at mesh ``coords``."""
        for dim in range(min(len(self.spec), x.ndim)):
            axes = self.split(dim)
            if axes:
                n = self.mesh.axis_size(axes)
                x = x.chunk(n, dim=dim)[self.shard_index(dim, coords)]
        return x

    def replica_axes(self):
        """Mesh axes along which the placement holds copies."""
        used = {a for e in self.spec for a in _entry_axes(e)}
        return tuple(a for a in self.mesh.shape if a not in used)


def _downgrade(name, shape, spec, mesh, why):
    """Replicate-with-warning for a matched but unplaceable spec."""
    telemetry.counter_inc("partition.replicated_fallback")
    with _downgrade_lock:
        fresh = (name, why) not in _DOWNGRADE_WARNED
        if fresh:
            _DOWNGRADE_WARNED.add((name, why))
    if fresh:
        from .. import log as _log
        _log.get_logger("mxnet_tpu_torch.partition").warning(
            "partition: parameter %r %s cannot take spec %s on mesh %s "
            "(%s) — replicating it instead",
            name, shape, tuple(spec), dict(mesh.shape), why)
    return Placement(mesh, P())


def sharding_for(mesh, name, shape, spec):
    """The :class:`Placement` of one parameter by its resolved rule spec,
    validated against the mesh: an axis the mesh lacks, a spec longer
    than the rank, or a dimension that does not divide by its axes'
    product downgrades to replicate (warned once, counted)."""
    shape = tuple(int(d) for d in shape)
    entries = tuple(spec)
    if not entries:
        return Placement(mesh, P())
    if len(entries) > len(shape):
        return _downgrade(name, shape, spec, mesh,
                          "spec rank %d exceeds tensor rank %d"
                          % (len(entries), len(shape)))
    axes = dict(mesh.shape)
    for dim, entry in enumerate(entries):
        if entry is None:
            continue
        factor = 1
        for ax in _entry_axes(entry):
            if ax not in axes:
                return _downgrade(name, shape, spec, mesh,
                                  "mesh has no %r axis" % (ax,))
            factor *= axes[ax]
        if factor and shape[dim] % factor != 0:
            return _downgrade(
                name, shape, spec, mesh,
                "dim %d (size %d) not divisible by the %r axis "
                "product %d" % (dim, shape[dim], entry, factor))
    return Placement(mesh, P(*entries))


def spec_nbytes(global_nbytes, shape, sharding):
    """Device-resident bytes of one placed array across its mesh:
    per-shard bytes summed over every device (a replicated array costs
    one full copy per device; a sharded dimension divides the copy)."""
    try:
        n = sharding.device_count
        if n <= 1:
            return int(global_nbytes)
        shard_shape = sharding.shard_shape(tuple(shape))
        total = int(global_nbytes) or 1
        full = math.prod(shape) if shape else 1
        per = (total * math.prod(shard_shape)) // max(full, 1) \
            if shape else total
        return per * n
    except Exception:
        return int(global_nbytes)


def committed_nbytes(arr, sharding=None):
    """``spec_nbytes`` of a tensor placed by ``sharding`` (its own bytes
    without one)."""
    nbytes = arr.numel() * arr.element_size()
    if sharding is None:
        return nbytes
    return spec_nbytes(nbytes, tuple(arr.shape), sharding)


def partition_summary(spec, param_shapes=None):
    """JSON-safe layout of one mesh spec (``spmd.DataParallelSpec``):
    the mesh axes, the data axis and, under rules, the rule tree and
    (with ``param_shapes``) the sharded parameters' resolved specs."""
    if spec is None:
        return None
    out = {
        "mesh_axes": {str(k): int(v) for k, v in spec.mesh.shape.items()},
        "data_axis": getattr(spec, "data_axis", None),
        "partition": None,
    }
    rules = getattr(spec, "rules", None)
    if rules is not None:
        out["partition"] = rules.describe()
        if param_shapes:
            sharded = {}
            for name, shape in param_shapes.items():
                ps = rules.spec_for(name, shape)
                if tuple(ps):
                    sharded[name] = list(tuple(ps))
            out["partition"]["sharded_params"] = sharded
    return out
