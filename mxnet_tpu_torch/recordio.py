"""RecordIO file format: pack/unpack, sequential and indexed readers/writers.

Counterpart of ``mxnet_tpu/recordio.py`` (the reference's
``python/mxnet/recordio.py`` over dmlc-core's RecordIO), byte for byte:
per record a little-endian uint32 magic (0xced7230a), a uint32 whose low
29 bits are the payload's length (the top 3 the continue flag, always 0
here), the payload, then zeros to a 4-byte boundary. An indexed file's
``.idx`` holds one ``key\\toffset`` line per record. Files written by
either package read in the other. ``io.ImageRecordIter`` reads such files
in bulk through the native loader (``_native.py``).
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple

import numpy as np

from .base import MXNetError
from .filesystem import open_uri

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_LMASK = (1 << 29) - 1

IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class MXRecordIO:
    """Sequential RecordIO reader (``flag="r"``) or writer (``"w"``)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.handle = open_uri(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = open_uri(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError("invalid flag %r" % self.flag)
        self.pid = os.getpid()

    def close(self):
        if self.handle is not None:
            self.handle.close()
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        d = dict(self.__dict__)
        d["handle"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.open()

    def _check_pid(self):
        # a forked child opens its own handle
        if self.pid != os.getpid():
            self.open()

    def write(self, buf):
        assert self.writable
        self._check_pid()
        length = len(buf)
        self.handle.write(struct.pack("<II", _MAGIC, length & _LMASK))
        self.handle.write(buf)
        pad = (4 - length % 4) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def read(self):
        """The next record's bytes, or None at the end of the file."""
        assert not self.writable
        self._check_pid()
        hdr = self.handle.read(8)
        if len(hdr) < 8:
            return None
        magic, lrec = struct.unpack("<II", hdr)
        if magic != _MAGIC:
            raise MXNetError("invalid RecordIO magic at offset %d"
                             % (self.handle.tell() - 8))
        length = lrec & _LMASK
        buf = self.handle.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.handle.read(pad)
        return buf

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.handle.tell()

    def seek(self, pos):
        self.handle.seek(pos)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access RecordIO with a ``.idx`` sidecar of ``key\\toffset``
    lines."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r":
            try:
                f = open_uri(self.idx_path, "r")
            except FileNotFoundError:
                f = None
            if f is not None:
                with f:
                    for line in f:
                        parts = line.strip().split("\t")
                        if len(parts) != 2:
                            continue
                        key = self.key_type(parts[0])
                        self.idx[key] = int(parts[1])
                        self.keys.append(key)
            self.fidx = None
        elif self.flag == "w":
            self.fidx = open_uri(self.idx_path, "w")

    def close(self):
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def read_idx(self, idx):
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


def pack(header, s):
    """An ``IRHeader`` and a payload as one record's bytes. A list or
    array label is the multi-label form: ``flag`` = the count, ``label``
    0, and the float32 labels before the payload."""
    header = IRHeader(*header)
    label = header.label
    if isinstance(label, (list, tuple, np.ndarray)):
        labels = np.asarray(label, np.float32)
        header = header._replace(flag=labels.size, label=0.0)
        s = labels.tobytes() + s
    return struct.pack(_IR_FORMAT, header.flag, header.label, header.id,
                       header.id2) + s


def unpack(s):
    """A record's ``(IRHeader, payload)``; a multi-label header's
    ``label`` is the float32 array of its ``flag`` labels."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    payload = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(payload, np.float32, header.flag)
        header = header._replace(label=label)
        payload = payload[header.flag * 4:]
    return header, payload


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack an image array as its raw uint8 bytes (as the JAX package
    does: no encoder; ``quality`` and ``img_fmt`` are accepted and
    unused)."""
    img = np.ascontiguousarray(np.asarray(img, np.uint8))
    return pack(header, img.tobytes())


def unpack_img(s, iscolor=-1):
    """``(IRHeader, flat uint8 array of the payload)``."""
    header, payload = unpack(s)
    return header, np.frombuffer(payload, np.uint8)
