"""Class registries keyed by base class.

Counterpart of ``mxnet_tpu/registry.py`` (parity: reference
``python/mxnet/registry.py``, backed there by ``MXNetCallbackList`` in
the C API; plain Python here): ``get_register_func``, ``get_alias_func``
and ``get_create_func`` make a kind's ``register``, ``alias`` and
``create``. A nickname shares its table with ``base.registry_create`` of
the same kind, so the built-in optimizers, metrics, initializers and
data iterators are visible through it and what it registers is visible
to their ``create``. ``create`` also takes the reference's JSON
``[name, kwargs]`` strings, the form in which a store ships an optimizer.
"""
from __future__ import annotations

import json
import logging

from .base import MXNetError, _KIND_REGISTRIES


def _registry_for(base_class, nickname):
    # shared with base.registry_create(nickname): optimizer/metric/
    # initializer built-ins registered through those kind registries are
    # visible here, and vice versa
    return _KIND_REGISTRIES.setdefault(nickname, {})


def get_register_func(base_class, nickname):
    """Make a ``register`` decorator for subclasses of ``base_class``."""
    registry = _registry_for(base_class, nickname)

    def register(klass, name=None):
        assert issubclass(klass, base_class), \
            "Can only register subclass of %s" % base_class.__name__
        if name is None:
            name = klass.__name__
        name = name.lower()
        if name in registry and registry[name] is not klass:
            logging.warning(
                "\033[91mNew %s %s.%s registered with name %s is overriding "
                "existing %s %s.%s\033[0m", nickname, klass.__module__,
                klass.__name__, name, nickname,
                registry[name].__module__, registry[name].__name__)
        registry[name] = klass
        return klass

    register.__doc__ = "Register %s to the %s factory" % (nickname, nickname)
    return register


def get_alias_func(base_class, nickname):
    """Make an ``alias`` decorator registering extra names."""
    register = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            for name in aliases:
                register(klass, name)
            return klass
        return reg

    return alias


def get_create_func(base_class, nickname):
    """Make a ``create`` factory for registered subclasses.

    Accepts a name string, a JSON ``[name, kwargs]`` string (the wire
    format kvstore uses to ship optimizers to servers), or an existing
    instance (returned as-is when no extra kwargs are given).
    """
    registry = _registry_for(base_class, nickname)

    def create(*args, **kwargs):
        if len(args):
            name = args[0]
            args = args[1:]
        else:
            name = kwargs.pop(nickname)
        if isinstance(name, base_class):
            assert not args and not kwargs, \
                "%s is already an instance. Additional arguments are invalid" \
                % nickname
            return name
        if isinstance(name, str) and name.startswith("["):
            assert not args and not kwargs
            name, kwargs = json.loads(name)
        name = name.lower()
        if name not in registry:
            raise MXNetError(
                "%s is not registered. Known %ss: %s"
                % (name, nickname, ", ".join(sorted(registry))))
        klass = registry[name]
        # the kind registry is shared by nickname (so built-ins registered
        # via base.registry_create stay visible); guard against a
        # same-nickname registry for an unrelated base handing back a
        # non-subclass
        if not issubclass(klass, base_class):
            raise MXNetError(
                "%s %r resolves to %s which is not a subclass of %s"
                % (nickname, name, klass.__name__, base_class.__name__))
        return klass(*args, **kwargs)

    create.__doc__ = "Create a %s instance from config" % nickname
    return create
