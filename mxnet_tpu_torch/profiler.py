"""Profiler — one chrome trace of device execution and host spans.

Counterpart of ``mxnet_tpu/profiler.py`` (parity: reference
``src/engine/profiler.{h,cc}`` + ``python/mxnet/profiler.py``;
chrome://tracing JSON output) over ``torch.profiler``: CPU operators
and, on the card, CUDA kernels and copies (Kineto). ``set_state("stop")``
(or ``dump()``) writes ONE perfetto-loadable JSON at the configured
filename, with the telemetry host spans (``serve_batch``, ``feed``,
``step``, ...) and their causal flow events merged into Kineto's event
list on Kineto's timebase, the program cards under
``otherData.mxnet_tpu_programs`` and the flight sampler's recent series
under ``otherData.mxnet_tpu_series``, and the process's counts of
hand-written kernel launches so far (K1-K3's wrappers and ``mx.rtc``'s)
under ``otherData.mxnet_kernel_launches``: a program over the C ABI has
no Python to read them with. Kineto's raw export stays beside it in
``<filename stem>_trace/``.

``pause``/``resume`` are no-ops, as in the JAX package.
``MXNET_PROFILER_AUTOSTART=1`` starts tracing at import (``config.py``).
"""
from __future__ import annotations

import json
import os

import torch

from .base import MXNetError, get_env  # noqa: F401 (the JAX module's name)
from . import telemetry

__all__ = ["profiler_set_config", "profiler_set_state", "set_config",
           "set_state", "dump", "pause", "resume", "Scope", "dump_profile",
           "kernel_launches"]

_state = {"running": False, "filename": "profile.json", "dir": None,
          "prof": None}

# the annotation recorded the instant tracing starts: its Kineto stamp
# and telemetry's trace-start stamp are one instant on two clocks
_ANCHOR = "mxnet_trace_start"


def _config():
    """Kineto's config recording operators on every thread (the serving
    engine's coalescer, the decode scheduler), where this torch has the
    option; otherwise None (the launching thread's operators only)."""
    from torch._C._profiler import _ExperimentalConfig
    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


def set_config(profile_all=None, profile_symbolic=None,
               profile_imperative=None, profile_memory=None, profile_api=None,
               filename="profile_output.json", **kwargs):
    """(parity: mx.profiler.set_config / MXSetProcessProfilerConfig)"""
    _state["filename"] = filename


profiler_set_config = set_config


def set_state(state="stop", profile_process="worker"):
    """(parity: mx.profiler.set_state — 'run' starts tracing, 'stop'
    writes the merged trace)"""
    if state == "run":
        if not _state["running"]:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts,
                                          experimental_config=_config())
            prof.__enter__()
            # the first annotation of a trace is slow to open (hundreds
            # of microseconds): warm it, so the anchor's Kineto stamp
            # lands within microseconds of the telemetry stamp
            with torch.profiler.record_function(_ANCHOR + "_warm"):
                pass
            telemetry.mark_trace_start()
            with torch.profiler.record_function(_ANCHOR):
                pass
            _state["prof"] = prof
            _state["dir"] = os.path.splitext(_state["filename"])[0] \
                + "_trace"
            _state["running"] = True
    elif state == "stop":
        if _state["running"]:
            prof, _state["prof"] = _state["prof"], None
            _state["running"] = False
            prof.__exit__(None, None, None)
            os.makedirs(_state["dir"], exist_ok=True)
            prof.export_chrome_trace(os.path.join(_state["dir"],
                                                  "trace.json"))
            _link_chrome_trace()
    else:
        raise MXNetError("state must be 'run' or 'stop'")


profiler_set_state = set_state


# any epoch-microsecond stamp after ~1973 exceeds this; a trace-relative
# stamp would need a ~3-year-long trace to reach it
_EPOCH_TS_FLOOR_US = 1e14


def _aligned_host_events(device_events, host):
    """Host span events on the device trace's timebase. Telemetry stamps
    spans in epoch microseconds; Kineto stamps events relative to its own
    base. The anchor annotation recorded at trace start maps
    ``telemetry.trace_start_epoch_us()`` onto its Kineto stamp, and every
    host event shifts by the difference. Without the anchor, the rule of
    the JAX package's ``_aligned_host_events``: epoch-based device stamps
    need no adjustment; trace-relative ones get the trace start mapped
    onto the earliest device stamp."""
    t0_us = telemetry.trace_start_epoch_us()
    if t0_us is None:
        return host
    anchor = [e["ts"] for e in device_events
              if e.get("name") == _ANCHOR and "ts" in e]
    if anchor:
        shift = min(anchor) - t0_us
    else:
        dts = [e["ts"] for e in device_events
               if e.get("ph") in ("X", "B") and "ts" in e]
        if not dts or min(dts) > _EPOCH_TS_FLOOR_US:
            return host
        shift = min(dts) - t0_us
    for e in host:
        if "ts" in e:
            e["ts"] = round(e["ts"] + shift, 3)
    return host


def _link_chrome_trace():
    """Write the configured filename: Kineto's events (when its export
    exists) with the telemetry host spans, program cards and the flight
    series merged in. A host-span-only trace is written when there is no
    export, so the configured filename always materialises."""
    out_dir = _state["dir"]
    if not out_dir:
        return
    trace = None
    src = os.path.join(out_dir, "trace.json")
    if os.path.exists(src):
        with open(src, "rb") as f:
            raw = f.read()
        try:
            trace = json.loads(raw.decode("utf-8", "replace"))
        except ValueError:
            # an unparseable export is surfaced verbatim, not lost
            with open(_state["filename"], "wb") as dst:
                dst.write(raw)
            return
    if not isinstance(trace, dict) or \
            not isinstance(trace.get("traceEvents"), list):
        events = trace if isinstance(trace, list) else []
        trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    trace["traceEvents"].extend(
        _aligned_host_events(trace["traceEvents"],
                             telemetry.chrome_events()))
    cards = telemetry.programs()
    if cards:
        trace.setdefault("otherData", {})["mxnet_tpu_programs"] = cards
    trace.setdefault("otherData", {})["mxnet_kernel_launches"] = \
        kernel_launches()
    from . import flight
    samples = flight.series(240)
    if samples:
        trace.setdefault("otherData", {})["mxnet_tpu_series"] = samples
    with open(_state["filename"], "w") as dst:
        json.dump(trace, dst)


def kernel_launches():
    """{kernel: launches so far in this process} of the hand-written
    kernels' wrappers: K1 (``scale_bias_add_relu`` and its backward), K2
    and K3 (flash attention's forward and backward) and K4 (``mx.rtc``'s
    launches). ``scale_bias_add_relu_backward`` counts backward calls:
    each is two device kernels, the pass and the finishing reduction."""
    from . import rtc
    from .kernels import fused_bn, flash_attention
    return {"scale_bias_add_relu": fused_bn.launches,
            "scale_bias_add_relu_backward": fused_bn.bwd_launches,
            "flash_attention_fwd": flash_attention.fwd_launches,
            "flash_attention_bwd": flash_attention.bwd_launches,
            "rtc": rtc.launches}


def dump(finished=True, profile_process="worker"):
    """(parity: mx.profiler.dump)"""
    if _state["running"]:
        set_state("stop")


def pause(profile_process="worker"):
    pass


def resume(profile_process="worker"):
    pass


class Scope:
    """Annotate a region so it shows up in the device trace
    (``torch.profiler.record_function``) AND as a telemetry host span
    (so the region also lands in the merged dump and the snapshot
    percentiles)."""

    def __init__(self, name):
        self._ann = torch.profiler.record_function(name)
        self._span = telemetry.span(name)

    def __enter__(self):
        self._span.__enter__()
        try:
            self._ann.__enter__()
        except BaseException:
            # the annotation failing to arm must not leave the host span
            # entered forever — every entered span exits
            self._span.__exit__(None, None, None)
            raise
        return self

    def __exit__(self, *exc):
        self._ann.__exit__(*exc)
        self._span.__exit__(*exc)


def dump_profile():
    """Deprecated alias of dump() (parity: profiler.dump_profile)."""
    dump(True)
