"""The program-card corpus: measured serving data across runs.

A copy of the card-corpus tier of ``mxnet_tpu/compile_cache.py``
(:515-600: ``corpus_path``, ``corpus_append``, ``corpus_records``) with
``env_meta`` naming this process's torch, CUDA, driver and card. An
engine appends one ``corpus_record()`` at ``close()``; the next
``InferenceEngine(autotune=True)`` plans its buckets from the records
(``tuner.plan_serving``).

The JAX package's executable store (:1-514: serialized XLA executables
keyed by StableHLO content, the trace-skip index) has no counterpart:
the port compiles no programs — graphs run op by op on PyTorch's
operators, and the only compiled code, the hand-written kernels, is
built once by ``nvcc`` and cached under ``kernels/_build/``.

``MXNET_CARD_CORPUS`` names the JSONL file (``0`` or unset disables);
without it, ``MXNET_COMPILE_CACHE``'s directory holds
``card_corpus.jsonl`` as in the JAX package.
"""
from __future__ import annotations

import json
import os
import threading

import torch

from . import telemetry
from .log import get_logger

__all__ = ["corpus_path", "corpus_append", "corpus_records", "env_meta"]

_log = get_logger("mxnet_tpu_torch.compile_cache")
_lock = threading.Lock()


def env_meta():
    """The identity of THIS process's runtime, stamped on every corpus
    record: torch and CUDA versions, the driver, and the cards (name and
    compute capability), or ``devices: []`` without CUDA."""
    meta = {"torch": torch.__version__, "cuda": torch.version.cuda,
            "driver": None, "devices": []}
    if torch.cuda.is_available():
        drv = getattr(torch._C, "_cuda_getDriverVersion", None)
        meta["driver"] = drv() if drv is not None else None
        for i in range(torch.cuda.device_count()):
            meta["devices"].append(
                [torch.cuda.get_device_name(i),
                 list(torch.cuda.get_device_capability(i))])
    return meta


def corpus_path():
    """The JSONL corpus file: ``MXNET_CARD_CORPUS`` if set (``0``/empty
    disables), else ``<MXNET_COMPILE_CACHE>/card_corpus.jsonl``, else
    None."""
    p = os.environ.get("MXNET_CARD_CORPUS", "")
    if p == "0":
        return None
    if p:
        return p
    d = os.environ.get("MXNET_COMPILE_CACHE", "")
    return os.path.join(d, "card_corpus.jsonl") if d and d != "0" \
        else None


def corpus_append(record, path=None):
    """Append one JSON record (a dict; a ``kind`` field keys readers)
    to the corpus. Returns True when written. Never raises — the
    corpus is telemetry, not state."""
    path = path or corpus_path()
    if path is None or not isinstance(record, dict):
        return False
    try:
        line = json.dumps(record, sort_keys=True)
    except (TypeError, ValueError) as e:
        _log.warning("compile_cache: corpus record not JSON-safe: %s", e)
        return False
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with _lock:
            with open(path, "a") as f:
                f.write(line + "\n")
    except OSError as e:
        _log.warning("compile_cache: corpus append to %s failed: %s",
                     path, e)
        return False
    telemetry.counter_inc("compile_cache.corpus_append")
    return True


def corpus_records(path=None, kind=None):
    """All parseable corpus records, oldest first (``kind`` filters on
    the record's ``kind`` field). Unparseable lines — a run killed
    mid-append — are skipped, not fatal."""
    path = path or corpus_path()
    if path is None or not os.path.exists(path):
        return []
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError as e:
        _log.warning("compile_cache: corpus read from %s failed: %s",
                     path, e)
        return []
    out = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and (kind is None
                                      or rec.get("kind") == kind):
            out.append(rec)
    return out
