"""Gluon utilities (parity: ``mxnet_tpu/gluon/utils.py``)."""
from __future__ import annotations

import hashlib
import math
import os

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``data`` cut into ``num_slice`` slices along ``batch_axis``."""
    size = data.shape[batch_axis]
    if size < num_slice:
        raise MXNetError("batch size %d < num_slice %d" % (size, num_slice))
    if even_split and size % num_slice != 0:
        raise MXNetError("uneven split of %d into %d" % (size, num_slice))
    step = size // num_slice
    return [data.slice_axis(batch_axis, i * step,
                            (i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """One slice of ``data`` per context, on it."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm):
    """Scale ``arrays`` in place so their joint L2 norm is at most
    ``max_norm``; returns the norm before clipping."""
    if not arrays:
        raise MXNetError("arrays must be non-empty")
    total = math.sqrt(sum(float(arr.norm().asscalar()) ** 2
                          for arr in arrays))
    if total > max_norm:
        scale = max_norm / (total + 1e-8)
        for arr in arrays:
            arr *= scale
    return total


def check_sha1(filename, sha1_hash):
    """True when the file's SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1048576), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    """No network here: returns ``path`` when the file is already there,
    else raises (place the file at ``path`` by hand)."""
    if path is not None and os.path.exists(path) and not overwrite:
        return path
    raise MXNetError("download %r: this build has no network access; "
                     "place the file at the target path by hand" % (url,))
