"""URI-aware stream opening for save/load and RecordIO.

Counterpart of ``mxnet_tpu/filesystem.py`` (the reference's dmlc
``Stream::Create``, which dispatches on the URI scheme). ``file://`` and
plain paths open locally; any other scheme needs an opener registered
with :func:`register_scheme` (the build reaches no network by itself).
``nd.save``/``nd.load``, ``Symbol.save``/``sym.load`` and ``recordio``
open their files here.

    from mxnet_tpu_torch import filesystem
    filesystem.register_scheme("s3", lambda uri, mode: s3fs.open(uri, mode))
    mx.nd.save("s3://bucket/weights.params", arrs)
"""
from __future__ import annotations

import os

from .base import MXNetError

__all__ = ["open_uri", "register_scheme", "scheme_of"]

_OPENERS = {}


def scheme_of(uri):
    """The URI's scheme, or "" for a plain local path (Windows drive
    letters such as "C:\\..." are local too)."""
    if not isinstance(uri, (str, os.PathLike)):
        return ""
    head, sep, _ = os.fspath(uri).partition("://")
    if not sep or len(head) <= 1:
        return ""
    return head.lower()


def register_scheme(scheme, opener):
    """Register ``opener(uri, mode) -> file object`` for a URI scheme."""
    if not scheme or "://" in scheme:
        raise MXNetError("scheme must be a bare name like 's3'")
    _OPENERS[scheme.lower()] = opener


def open_uri(uri, mode="rb"):
    """Open a local path, a ``file://`` URI or a registered scheme."""
    scheme = scheme_of(uri)
    uri = os.fspath(uri)
    if scheme in ("", "file"):
        return open(uri[len("file://"):] if scheme == "file" else uri, mode)
    opener = _OPENERS.get(scheme)
    if opener is None:
        raise MXNetError(
            "no stream handler for %r URIs: register one with "
            "mxnet_tpu_torch.filesystem.register_scheme(%r, opener)"
            % (scheme, scheme))
    return opener(uri, mode)
