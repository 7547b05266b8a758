"""Multi-process runtime wiring over ``torch.distributed``.

Counterpart of ``mxnet_tpu/dist.py`` (parity: the reference's ps-lite
environment, ``KVStore::InitPSEnv``). Every worker runs the same
program; ``python -m mxnet_tpu_torch.launch -n N -- <command>`` exports
the environment this module reads when ``mxnet_tpu_torch`` is imported:
``MXNET_TPU_COORDINATOR`` (``host:port``), ``MXNET_TPU_NUM_PROCESSES``,
``MXNET_TPU_PROCESS_ID`` and the reference's role names
(``DMLC_ROLE``, ``DMLC_NUM_WORKER``, ``DMLC_WORKER_ID``).
:func:`init_from_env` then calls ``torch.distributed.init_process_group``
for the default group; a mesh over the job's processes adds one subgroup
for each line of its axes (``parallel/mesh.py``).

Backend rule. Each rank publishes the identity of the device it trains
on (the UUID of its first visible CUDA device, or ``cpu``) through the
rendezvous store, and every rank derives the same choice from the whole
list:

- ``nccl`` when every rank has a CUDA device of its own;
- ``gloo`` when two or more ranks share a device (NCCL refuses two
  ranks on one device; four ranks on one card take gloo too) or any rank
  has no CUDA device.

``MXNET_TPU_DIST_BACKEND`` forces one. The choice and its reason are
printed on each rank's standard error. Collectives of CUDA tensors over
``gloo`` go through pinned host buffers (``parallel/collectives.py``).

Batch statistics. Training-mode BatchNorm takes its statistics over the
global batch only in the fused step of a ``Module`` over a synchronous
``dist*`` store (one collective per layer forward and one backward; see
``ops/nn.py`` ``batch_stats_over``), as the JAX package's
process-spanning dp program does; the phase-split dist path and the Gluon
``Trainer`` take each worker's own rows, as the JAX package's do.

Elastic membership (the JAX module's survivable client). Liveness is
the heartbeat directory's (``heartbeat.py``); a survivor that names a
dead peer calls :func:`mark_member_lost`. From then on
:func:`live_ranks` excludes it, and every collective the port issues
over the default group takes :func:`live_group` instead: a
``torch.distributed`` group over the survivors, built on the existing
rendezvous store with ``use_local_synchronization`` (a group over the
world would need the dead rank's call too), or no group at all for the
last one standing. A process keeps its global rank as its identity
(file names, postmortems); the group rank is taken only at the call.
:func:`finalize` then leaves the world group alone (its teardown would
touch the dead peer). Rank 0 hosts the rendezvous store, so the loss of
rank 0 is fatal: :func:`mark_member_lost` raises for it, as the JAX
package's coordinator is its single point of failure.
"""
from __future__ import annotations

import datetime
import os
import sys
import threading

from .base import MXNetError

__all__ = ["init_from_env", "initialized", "rank", "process_count",
           "live_ranks", "mark_member_lost", "dead_ranks", "live_group",
           "finalize", "abort", "backend", "backend_reason", "ENV_COORDINATOR",
           "ENV_BACKEND"]

ENV_COORDINATOR = "MXNET_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "MXNET_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "MXNET_TPU_PROCESS_ID"
ENV_BACKEND = "MXNET_TPU_DIST_BACKEND"
ENV_INIT_TIMEOUT = "MXNET_TPU_DIST_INIT_TIMEOUT"

_lock = threading.Lock()
_state = {"initialized": False,     # guarded by: _lock
          "backend": None,          # guarded by: _lock
          "reason": None,           # guarded by: _lock
          "dead": frozenset(),      # guarded by: _lock
          "live_group": None}       # guarded by: _lock

# what :func:`live_group` answers for the last process standing
ALONE = "alone"


def _device_identity():
    """What this rank trains on: the UUID of its first visible CUDA
    device (``CUDA_VISIBLE_DEVICES`` narrows it per rank), else ``cpu``."""
    import torch
    if not torch.cuda.is_available():
        return "cpu"
    props = torch.cuda.get_device_properties(0)
    uuid = getattr(props, "uuid", None)
    return "cuda:%s" % (uuid if uuid is not None else props.pci_bus_id)


def choose_backend(identities):
    """``(backend, reason)`` from every rank's device identity (the
    rule of the module docstring); ``MXNET_TPU_DIST_BACKEND`` wins."""
    forced = os.environ.get(ENV_BACKEND)
    if forced:
        if forced not in ("gloo", "nccl"):
            raise MXNetError("%s=%r: use gloo or nccl" % (ENV_BACKEND, forced))
        return forced, "forced by %s" % ENV_BACKEND
    if any(i == "cpu" for i in identities):
        return "gloo", "a rank has no CUDA device"
    if len(set(identities)) < len(identities):
        return "gloo", "ranks share a CUDA device"
    return "nccl", "every rank has a CUDA device of its own"


def init_from_env():
    """Join the job the launch environment describes; a no-op without
    ``MXNET_TPU_COORDINATOR``. Returns True when a multi-process
    runtime is (now) initialised. A worker that cannot reach the
    coordinator raises: it must not train as a one-process job."""
    addr = os.environ.get(ENV_COORDINATOR)
    if not addr:
        return False
    import torch.distributed as tdist
    with _lock:
        if _state["initialized"] or tdist.is_initialized():
            _state["initialized"] = True
            return True
        nproc = int(os.environ.get(ENV_NUM_PROCESSES, "1"))
        pid = int(os.environ.get(ENV_PROCESS_ID, "0"))
        host, port = addr.rsplit(":", 1)
        timeout = datetime.timedelta(
            seconds=float(os.environ.get(ENV_INIT_TIMEOUT, "300")))
        store = tdist.TCPStore(host, int(port), nproc, pid == 0,
                               timeout=timeout)
        store.set("mxnet_tpu_torch/device/%d" % pid, _device_identity())
        ids = [store.get("mxnet_tpu_torch/device/%d" % r).decode()
               for r in range(nproc)]
        backend_name, reason = choose_backend(ids)
        if backend_name == "nccl":
            import torch
            torch.cuda.set_device(0)
        tdist.init_process_group(backend_name, store=store, rank=pid,
                                 world_size=nproc, timeout=timeout)
        _state.update(initialized=True, backend=backend_name, reason=reason)
    print("mxnet_tpu_torch.dist: rank %d of %d, backend %s (%s)"
          % (pid, nproc, backend_name, reason), file=sys.stderr, flush=True)
    return True


def initialized():
    """Whether a multi-process runtime is live."""
    try:
        import torch.distributed as tdist
        return tdist.is_available() and tdist.is_initialized()
    except ImportError:
        return False


def backend():
    """The default group's backend (``gloo``/``nccl``), None outside a
    multi-process run."""
    if not initialized():
        return None
    import torch.distributed as tdist
    return tdist.get_backend()


def backend_reason():
    """Why :func:`init_from_env` chose the backend (None when this
    module did not initialise the group)."""
    with _lock:
        return _state["reason"]


def rank():
    """This process's index in the job (``DMLC_RANK`` or 0 outside a
    multi-process run)."""
    if not initialized():
        return int(os.environ.get("DMLC_RANK", 0))
    import torch.distributed as tdist
    return tdist.get_rank()


def process_count():
    """Processes launched into the job (``DMLC_NUM_WORKER`` or 1 outside
    a multi-process run)."""
    if not initialized():
        return int(os.environ.get("DMLC_NUM_WORKER", 1))
    import torch.distributed as tdist
    return tdist.get_world_size()


def live_ranks():
    """Sorted surviving ranks: every launched rank minus those
    :func:`mark_member_lost` recorded."""
    with _lock:
        dead = _state["dead"]
    return tuple(r for r in range(process_count()) if r not in dead)


def dead_ranks():
    """Sorted ranks recorded dead so far."""
    with _lock:
        return tuple(sorted(_state["dead"]))


def mark_member_lost(ranks):
    """Record dead peers: :func:`live_ranks` excludes them, collectives
    over the default group move to the survivors' group
    (:func:`live_group`) and :func:`finalize` skips the world group's
    teardown. The loss of rank 0, which hosts the rendezvous store, is
    fatal and raises."""
    ranks = frozenset(int(r) for r in ranks)
    if 0 in ranks and initialized() and process_count() > 1:
        raise MXNetError(
            "rank 0 is lost: it hosts the rendezvous store every group is "
            "built on, so the job cannot re-mesh without it (its loss is "
            "fatal, as the JAX package's coordinator's is)")
    with _lock:
        if ranks <= _state["dead"]:
            return
        _state["dead"] = _state["dead"] | ranks
        _state["live_group"] = None


def live_group():
    """The group collectives over the default group take: None while no
    member is lost (the world group), else the survivors' group (built
    on first use; every survivor reaches it in the same order), or
    :data:`ALONE` for the last process standing."""
    with _lock:
        dead, pg = _state["dead"], _state["live_group"]
    if not dead or not initialized():
        return None
    if pg is not None:
        return pg
    live = live_ranks()
    if len(live) <= 1:
        pg = ALONE
    else:
        import torch.distributed as tdist
        pg = tdist.new_group(ranks=list(live), use_local_synchronization=True)
    with _lock:
        if _state["dead"] == dead:
            _state["live_group"] = pg
    return pg


def finalize():
    """Tear the default group down (all workers call it at job end);
    idempotent, a no-op in one-process runs. After a member loss the
    groups are left to the process's exit: their teardown would wait on
    the dead peer."""
    with _lock:
        _state["initialized"] = False
        lost = bool(_state["dead"])
    if initialized() and not lost:
        import torch.distributed as tdist
        tdist.destroy_process_group()


def abort(code=0):
    """Exit now without running destructors or atexit hooks, as the JAX
    package's workers die: a nonzero code banks a ``worker_abort``
    postmortem first (best effort); stdio is flushed."""
    if int(code) != 0:
        try:
            from . import flight
            flight.postmortem("worker_abort", exc=sys.exc_info()[1],
                              extra={"exit_code": int(code)}, force=True)
        except Exception:       # a recorder failure must not stop the exit
            pass
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:
        pass
    os._exit(int(code))
