"""Foundation utilities: the framework error and typed env-var lookup.

Counterpart of ``mxnet_tpu/base.py`` (kept as a copy: the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import os

from .telemetry import _percentile

__all__ = ["MXNetError", "get_env", "latency_percentiles",
           "registry_create"]


class MXNetError(RuntimeError):
    """Error raised by the framework (parity: reference python/mxnet/base.py MXNetError)."""


def get_env(name, default=None, typ=None):
    """Typed environment-variable lookup (parity: dmlc::GetEnv).

    All ``MXNET_*`` runtime knobs route through here.
    """
    val = os.environ.get(name)
    if val is None:
        return default
    if typ is bool or isinstance(default, bool):
        return val.lower() not in ("0", "false", "off", "")
    if typ is int or isinstance(default, int):
        return int(val)
    if typ is float or isinstance(default, float):
        return float(val)
    return val


def latency_percentiles(samples_ms):
    """``{p50_ms, p95_ms, p99_ms}`` of latency samples in ms, by the
    nearest rank (``telemetry._percentile``, the one percentile rule)
    and rounded to 4 decimals as the JAX package reports them; None
    without samples."""
    s = sorted(float(x) for x in samples_ms)
    if not s:
        return None
    return {"p%d_ms" % q: round(_percentile(s, q), 4) for q in (50, 95, 99)}


# kind nickname -> {lower-cased name: class}; shared with registry.py's
# get_register_func/get_create_func of the same nickname
_KIND_REGISTRIES = {}


def registry_create(kind):
    """A small ``(register, alias, create, get)`` registry for one kind
    (the dmlc registry pattern the reference uses for optimizers,
    metrics, initializers and data iterators)."""
    entries = _KIND_REGISTRIES.setdefault(kind, {})

    def register(cls=None, name=None):
        def _reg(cls):
            entries[(name or cls.__name__).lower()] = cls
            return cls

        if cls is None:
            return _reg
        return _reg(cls)

    def alias(name, cls):
        entries[name.lower()] = cls

    def create(name, *args, **kwargs):
        key = name.lower()
        if key not in entries:
            raise MXNetError("%s %r is not registered (known: %s)"
                             % (kind, name, sorted(entries)))
        return entries[key](*args, **kwargs)

    def get(name):
        return entries.get(name.lower())

    return register, alias, create, get
