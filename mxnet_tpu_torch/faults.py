"""Deterministic fault injection: the chaos substrate for the runtime.

A whole copy of ``mxnet_tpu/faults.py`` (the port imports nothing of
the JAX package). A serving engine with deadlines, retry budgets and a
breaker is only trustworthy if its failure paths EXECUTE in tests — so
this module provides a process-global, env-gated injection registry the
runtime's own hot paths consult at named SITES. ``SITES`` is the JAX
package's tuple, so a spec that parses in one package parses in the
other:

========================  ===================================================
site                      where it fires in the port
========================  ===================================================
``dispatch``              ``executor._GraphProgram`` — every launch of
                          ``forward_fn``/``fwd_bwd_fn``/``train_step_fn``
                          (serving batch, training step, forward). ``nan``
                          fills the launch's outputs with NaN (the JAX
                          package ignores ``nan`` at this site)
``d2h``                   ``serving.InferenceEngine._resolve`` — the blocking
                          device-to-host fetch of a served batch
``io_next``               ``io.DataIter.__next__`` — one batch produced by
                          the input pipeline
``kv_push``               ``kvstore.KVStore.push`` — one gradient push
``kv_collective``         ``heartbeat.CollectiveGate.arrive_and_wait`` —
                          every gate crossing, before the arrival is
                          published (a raise is a worker dying at a
                          deterministic collective index)
``heartbeat``             ``heartbeat.start_heartbeat``'s thread — every
                          beat (a raise kills the beat thread: the worker
                          computes on but reads as dead; ``delay``
                          stretches the gap between beats)
``compile_cache.load``    parses but never fires: the executable store
                          has no counterpart (the port compiles nothing
                          but its kernels)
========================  ===================================================

Spec grammar (``MXNET_FAULTS`` env var, or ``configure()``)::

    spec     := rule (";" rule)*
    rule     := site ":" action [":" schedule ("," schedule)*]
    action   := "raise" | "delay=<ms>" | "nan"
    schedule := "n=<K>"      fire ONLY on the Kth call (1-based)
              | "every=<K>"  fire on every Kth call (K, 2K, 3K, ...)
              | "first=<K>"  fire on calls 1..K
              | "p=<prob>"   fire with probability prob per call
              | "seed=<S>"   seed for the p= draw (default 0 — the
                             schedule is DETERMINISTIC either way)

    MXNET_FAULTS="dispatch:raise:p=0.2,seed=7"       # flaky dispatch
    MXNET_FAULTS="d2h:nan:n=3;io_next:delay=50:every=10"

Actions: ``raise`` raises :class:`InjectedFault` (an ``MXNetError``
marked ``transient`` so the serving retry budget applies); ``delay``
sleeps the given milliseconds; ``nan`` asks the SITE to corrupt its
payload (``fire()`` returns ``"nan"`` and the caller applies
:func:`poison` — sites without a float payload treat it as a no-op).

Every injection is counted twice: here (``counts()`` — exact,
independent of the telemetry enable flag, what tests assert on) and in
the telemetry registry (``faults.injected.<site>`` via
``telemetry.record_fault``) so the chaos lane's artifact carries the
fire counts next to the shed/retry counters they caused. The whole
module is inert (one dict check per site) when no spec is configured.
"""
from __future__ import annotations

import os
import random as _pyrandom
import threading
import time

import numpy as np
import torch

from .base import MXNetError
from . import telemetry

__all__ = ["InjectedFault", "SITES", "configure", "clear", "active",
           "fire", "counts", "reset_counts", "poison", "spec"]

ENV = "MXNET_FAULTS"

# the named sites the runtime consults — a spec naming anything else is
# a typo that would otherwise never fire, so parsing rejects it
SITES = ("dispatch", "d2h", "compile_cache.load", "io_next", "kv_push",
         "kv_collective", "heartbeat")

_ACTIONS = ("raise", "delay", "nan")


class InjectedFault(MXNetError):
    """An injected failure. ``site`` names where it fired; ``transient``
    is True (the serving retry budget treats injected dispatch faults
    as retryable, exactly like a flaky backend RPC)."""

    def __init__(self, site, message=None):
        super().__init__(message or "injected fault at site %r" % site)
        self.site = site
        self.transient = True


class _Rule:
    __slots__ = ("site", "action", "delay_ms", "n", "every", "first",
                 "p", "seed", "_rng", "fired")

    def __init__(self, site, action, delay_ms=0.0, n=None, every=None,
                 first=None, p=None, seed=0):
        self.site = site
        self.action = action
        self.delay_ms = delay_ms
        self.n = n
        self.every = every
        self.first = first
        self.p = p
        self.seed = seed
        # one private seeded stream per rule: the p= schedule replays
        # identically for a fixed seed regardless of other rules
        self._rng = _pyrandom.Random(seed) if p is not None else None
        self.fired = 0

    def should_fire(self, call_no):
        """Whether this rule fires on the site's ``call_no``-th call
        (1-based). The p= draw happens on EVERY call so the sequence of
        draws — hence the schedule — is deterministic in the seed."""
        if self._rng is not None:
            return self._rng.random() < self.p
        if self.n is not None:
            return call_no == self.n
        if self.every is not None:
            return call_no % self.every == 0
        if self.first is not None:
            return call_no <= self.first
        return True


_lock = threading.Lock()
_rules = {}          # guarded by: _lock
                     # site -> [rule, ...]
_calls = {}          # guarded by: _lock
                     # site -> call count (every consult, fired or not)
_loaded = False      # guarded by: _lock
                     # env spec parsed?
_spec = None         # guarded by: _lock
                     # the active spec string (for introspection)


def _parse_rule(text):
    parts = text.split(":")
    if len(parts) < 2 or len(parts) > 3:
        raise MXNetError(
            "faults: rule %r is not site:action[:schedule]" % text)
    site, action = parts[0].strip(), parts[1].strip()
    if site not in SITES:
        raise MXNetError("faults: unknown site %r (sites: %s)"
                         % (site, ", ".join(SITES)))
    delay_ms = 0.0
    if action.startswith("delay="):
        try:
            delay_ms = float(action[len("delay="):])
        except ValueError:
            raise MXNetError("faults: bad delay in %r" % text)
        action = "delay"
    if action not in _ACTIONS:
        raise MXNetError("faults: unknown action %r (actions: raise, "
                         "delay=<ms>, nan)" % action)
    kw = {}
    if len(parts) == 3:
        for term in parts[2].split(","):
            term = term.strip()
            if not term:
                continue
            k, _, v = term.partition("=")
            try:
                if k == "p":
                    kw["p"] = float(v)
                elif k in ("n", "every", "first", "seed"):
                    kw[k] = int(v)
                else:
                    raise ValueError(k)
            except ValueError:
                raise MXNetError("faults: bad schedule term %r in %r"
                                 % (term, text))
        if sum(k in kw for k in ("n", "every", "first", "p")) > 1:
            raise MXNetError(
                "faults: n=/every=/first=/p= are mutually exclusive "
                "in %r" % text)
        if "p" in kw and not 0.0 <= kw["p"] <= 1.0:
            raise MXNetError("faults: p must be in [0, 1] in %r" % text)
        for k in ("n", "every", "first"):
            if k in kw and kw[k] < 1:
                raise MXNetError("faults: %s must be >= 1 in %r"
                                 % (k, text))
    return _Rule(site, action, delay_ms=delay_ms, **kw)


def parse_spec(spec_text):
    """Parse a spec string into rules; raises ``MXNetError`` on any
    grammar error (a typo'd spec that silently never fires would defeat
    the whole point of a chaos lane)."""
    rules = []
    for chunk in (spec_text or "").split(";"):
        chunk = chunk.strip()
        if chunk:
            rules.append(_parse_rule(chunk))
    return rules


def configure(spec_text):
    """Install a fault spec process-globally (replacing any active one).
    ``None``/empty clears. Raises on grammar errors."""
    global _loaded, _spec
    rules = parse_spec(spec_text) if spec_text else []
    with _lock:
        _rules.clear()
        _calls.clear()
        for r in rules:
            _rules.setdefault(r.site, []).append(r)
        _loaded = True
        _spec = spec_text if rules else None


def clear():
    """Remove every rule and counter (the registry goes inert)."""
    configure(None)


def _ensure_loaded():
    global _loaded
    if _loaded:
        return
    env_spec = os.environ.get(ENV, "")
    if not env_spec:
        with _lock:
            _loaded = True
        return
    try:
        configure(env_spec)
    except MXNetError as e:
        # an env typo must not brick the process at an arbitrary
        # dispatch site — warn once and run fault-free
        from .log import get_logger
        get_logger("mxnet_tpu_torch.faults").warning(
            "faults: ignoring invalid %s spec: %s", ENV, e)
        configure(None)


def active():
    """Whether any rule is installed (after lazily reading the env)."""
    _ensure_loaded()
    return bool(_rules)


def spec():
    """The active spec string, or None."""
    _ensure_loaded()
    with _lock:
        return _spec


def fire(site):
    """Consult the registry at ``site``. Returns None (no injection or
    a delay already served), or ``"nan"`` when the caller should corrupt
    its payload with :func:`poison`; raises :class:`InjectedFault` for a
    ``raise`` rule. One dict lookup when no spec is configured."""
    if not _loaded:
        _ensure_loaded()
    if not _rules:
        return None
    with _lock:
        rules = _rules.get(site)
        if not rules:
            return None
        call_no = _calls.get(site, 0) + 1
        _calls[site] = call_no
        firing = [r for r in rules if r.should_fire(call_no)]
        for r in firing:
            r.fired += 1
    # account EVERY firing rule and serve every delay BEFORE raising:
    # a raise rule sharing the call with other firing rules must not
    # short-circuit their telemetry counts (the "counted exactly twice"
    # invariant the chaos lane gates on) or skip their delays
    out = None
    raise_after = False
    for r in firing:
        telemetry.record_fault(site)
        # flight record: the postmortem's event ring shows WHICH call
        # the chaos registry hit, interleaved with the sheds/retries/
        # trips it caused
        telemetry.record_event("fault.injected", site=site,
                               action=r.action, call=call_no)
    for r in firing:
        if r.action == "delay":
            time.sleep(r.delay_ms / 1e3)
        elif r.action == "nan":
            out = "nan"
        else:
            raise_after = True
    if raise_after:
        raise InjectedFault(site)
    return out


def counts():
    """{site: {"calls": N, "fired": M}} — exact per-site consult and
    injection counts since the last ``configure``/``reset_counts``.
    Independent of the telemetry enable flag (tests assert on these)."""
    with _lock:
        out = {}
        for site, rules in _rules.items():
            out[site] = {"calls": _calls.get(site, 0),
                         "fired": sum(r.fired for r in rules)}
        return out


def reset_counts():
    """Zero the call/fired counters and REWIND every p= stream to its
    seed — a fresh measurement window replays the same schedule."""
    with _lock:
        _calls.clear()
        for rules in _rules.values():
            for r in rules:
                r.fired = 0
                if r._rng is not None:
                    r._rng = _pyrandom.Random(r.seed)


def poison(arrays):
    """Corrupt-NaN (the ``nan`` action's payload transform — what a
    flipped DRAM bit or a bad collective does to a batch): a numpy float
    array gets element 0 set to NaN as in the JAX package (in place where
    writeable, via a copy otherwise); a floating ``torch.Tensor`` (a
    device payload, e.g. a launch's outputs) is filled with NaN in place.
    Anything else passes through untouched. Returns the list (same
    order)."""
    out = []
    for a in arrays:
        if isinstance(a, np.ndarray) and a.size \
                and np.issubdtype(a.dtype, np.floating):
            if not a.flags.writeable:
                a = a.copy()
            a.reshape(-1)[0] = np.nan
        elif isinstance(a, torch.Tensor) and a.is_floating_point():
            with torch.no_grad():
                a.fill_(float("nan"))
        out.append(a)
    return out
