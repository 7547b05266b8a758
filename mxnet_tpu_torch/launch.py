"""Launch N worker processes of one job (data, sequence, tensor, expert or
pipeline parallel: the mesh the workers build decides).

Counterpart of the JAX package's ``tools/launch.py`` (parity: the
reference's ``tools/launch.py`` over the dmlc tracker)::

    python -m mxnet_tpu_torch.launch -n 2 -- python train.py [args]

Every worker runs the same command with the environment
``mxnet_tpu_torch.dist`` reads at import: ``MXNET_TPU_COORDINATOR``
(``host:port`` of rank 0's rendezvous store), ``MXNET_TPU_NUM_PROCESSES``,
``MXNET_TPU_PROCESS_ID``, and the reference's ``DMLC_ROLE=worker``,
``DMLC_NUM_WORKER``, ``DMLC_WORKER_ID``. Without ``--port`` a free port
is picked. With at least as many CUDA devices as workers each local
worker sees only its own card (``CUDA_VISIBLE_DEVICES``), so its
``gpu(0)`` is that card and the ranks take ``nccl``; with fewer, the
workers share the cards they see and take ``gloo`` (``dist.py``'s
backend rule). ``--force-cpu`` hides every card from the workers.

``--launcher local`` (the default) starts the workers on this host and
waits. A worker that exits nonzero takes the others down (SIGTERM, then
SIGKILL after 5 s), and ``--timeout`` kills every worker when it
expires (a rank stuck in a collective whose peer died or never came);
either way the launcher exits nonzero (124 for the timeout).
``--launcher ssh`` prints one command per worker over the hosts of
``-H``, to run there. ``-s`` is accepted for the reference's command
line and ignored: gradients are all-reduced, no server process exists.

Elastic jobs (``heartbeat.py``): ``--heartbeat-dir DIR`` (wiped and made
afresh; on several hosts a shared mount), ``--heartbeat-interval`` and
``--heartbeat-timeout`` are exported to every worker as
``MXTPU_HEARTBEAT_DIR``/``_INTERVAL``/``_TIMEOUT``. Each worker's dist
store beats there, and a worker's nonzero exit is then a member death:
the others keep running (the survivors name the dead rank at their next
collective, re-mesh and resume from ``fit(checkpoint=...)``), and the
launcher exits with the OR of the workers' codes, as the JAX launcher
does. ``--timeout`` stays the backstop.
"""
from __future__ import annotations

import argparse
import os
import shlex
import shutil
import signal
import socket
import subprocess
import sys
import time

__all__ = ["build_env", "free_port", "launch_local", "ssh_commands", "main"]

_GRACE_S = 5.0


def free_port(host="127.0.0.1"):
    """A TCP port nothing listens on right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _local_cards():
    """CUDA devices this host shows the launcher (0 without torch's CUDA)."""
    try:
        import torch
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    except ImportError:
        return 0


def build_env(rank, args, base=None):
    """The environment of worker ``rank``."""
    env = dict(os.environ if base is None else base)
    env.update({
        "DMLC_ROLE": "worker",
        "DMLC_NUM_WORKER": str(args.num_workers),
        "DMLC_WORKER_ID": str(rank),
        "MXNET_TPU_COORDINATOR": "%s:%d" % (args.host, args.port),
        "MXNET_TPU_NUM_PROCESSES": str(args.num_workers),
        "MXNET_TPU_PROCESS_ID": str(rank),
    })
    if getattr(args, "heartbeat_dir", None):
        env.update({
            "MXTPU_HEARTBEAT_DIR": args.heartbeat_dir,
            "MXTPU_HEARTBEAT_INTERVAL": str(args.heartbeat_interval),
            "MXTPU_HEARTBEAT_TIMEOUT": str(args.heartbeat_timeout),
        })
    if args.force_cpu:
        env["CUDA_VISIBLE_DEVICES"] = ""
    elif args.own_cards:
        env["CUDA_VISIBLE_DEVICES"] = str(rank)
    return env


def _stop(procs):
    """SIGTERM every live worker's process group, SIGKILL after the grace."""
    for p in procs:
        if p.poll() is None:
            _signal_group(p, signal.SIGTERM)
    deadline = time.monotonic() + _GRACE_S
    for p in procs:
        try:
            p.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    for p in procs:
        if p.poll() is None:
            _signal_group(p, signal.SIGKILL)
            p.wait()


def _signal_group(p, sig):
    try:
        os.killpg(p.pid, sig)
    except (ProcessLookupError, PermissionError):
        pass


def launch_local(args, command):
    """Run ``command`` as ``args.num_workers`` local workers; returns the
    exit code: 0 when all succeed, the first failure's code (with
    ``--heartbeat-dir``: the OR of every worker's code, the others left
    running), or 124 at the timeout."""
    elastic = bool(getattr(args, "heartbeat_dir", None))
    procs = [subprocess.Popen(command, env=build_env(r, args),
                              start_new_session=True)
             for r in range(args.num_workers)]

    def _terminate(*_):
        _stop(procs)
        sys.exit(1)

    old = {s: signal.signal(s, _terminate)
           for s in (signal.SIGINT, signal.SIGTERM)}
    deadline = time.monotonic() + args.timeout if args.timeout else None
    reported = set()
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes)
                      if c is not None and c != 0]
            if failed and not elastic:
                r, c = failed[0]
                print("launch: worker %d exited with %d; stopping the "
                      "others" % (r, c), file=sys.stderr, flush=True)
                _stop(procs)
                return c if c > 0 else 1
            for r, c in failed:
                if r not in reported:
                    reported.add(r)
                    print("launch: worker %d exited with %d; a member "
                          "death, the others go on" % (r, c),
                          file=sys.stderr, flush=True)
            if all(c is not None for c in codes):
                rc = 0
                for c in codes:
                    rc |= c if c >= 0 else 1
                if elastic:
                    print("launch: worker exit codes %s" % codes,
                          file=sys.stderr, flush=True)
                return rc
            if deadline is not None and time.monotonic() > deadline:
                print("launch: --timeout %gs expired; killing %d worker(s)"
                      % (args.timeout, sum(c is None for c in codes)),
                      file=sys.stderr, flush=True)
                _stop(procs)
                return 124
            time.sleep(0.05)
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def ssh_commands(args, command):
    """One ``ssh`` command line per worker, round-robin over the hosts of
    ``args.hostfile``."""
    with open(args.hostfile) as f:
        hosts = [h.strip() for h in f if h.strip()]
    out = []
    for r in range(args.num_workers):
        env = build_env(r, args, base={})
        exports = " ".join("%s=%s" % (k, shlex.quote(v))
                           for k, v in sorted(env.items()))
        dst = shlex.quote(args.sync_dst_dir) if args.sync_dst_dir else "~"
        remote = "cd %s && env %s %s" % (
            dst, exports, " ".join(shlex.quote(c) for c in command))
        out.append(["ssh", "-o", "StrictHostKeyChecking=no",
                    hosts[r % len(hosts)], remote])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.launch",
        description="Launch a data-parallel job of N worker processes",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("-s", "--num-servers", type=int, default=0,
                    help="accepted for the reference's command line; "
                         "ignored (no server process exists)")
    ap.add_argument("--launcher", default="local", choices=["local", "ssh"])
    ap.add_argument("-H", "--hostfile", default=None)
    ap.add_argument("--host", default="127.0.0.1",
                    help="address of rank 0's rendezvous store")
    ap.add_argument("--port", type=int, default=None,
                    help="rendezvous port (default: a free one)")
    ap.add_argument("--timeout", type=float, default=0,
                    help="seconds after which every worker is killed and "
                         "the launcher exits 124 (0: none)")
    ap.add_argument("--force-cpu", action="store_true",
                    help="hide every CUDA device from the workers")
    ap.add_argument("--sync-dst-dir", default=None)
    ap.add_argument("--heartbeat-dir", default=None,
                    help="shared directory for worker liveness heartbeats; "
                         "wiped at launch. With it a worker's death leaves "
                         "the others running (elastic training)")
    ap.add_argument("--heartbeat-interval", type=float, default=1.0,
                    help="seconds between liveness beats")
    ap.add_argument("--heartbeat-timeout", type=float, default=10.0,
                    help="beat staleness after which a worker is declared "
                         "dead (how fast the survivors re-mesh)")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    command = args.command[1:] if args.command[:1] == ["--"] \
        else args.command
    if not command:
        ap.error("no command given")
    if args.num_workers < 1:
        ap.error("-n must be at least 1")
    if args.heartbeat_dir:
        # stale worker-* files of an earlier job would read as dead
        # workers: every job starts from a clean directory
        shutil.rmtree(args.heartbeat_dir, ignore_errors=True)
        os.makedirs(args.heartbeat_dir, exist_ok=True)
    if args.num_servers:
        print("launch: -s/--num-servers ignored: gradients are "
              "all-reduced, no server process exists", file=sys.stderr)
    if args.port is None:
        args.port = free_port(args.host if args.launcher == "local"
                              else "0.0.0.0")
    args.own_cards = (not args.force_cpu and args.launcher == "local"
                      and "CUDA_VISIBLE_DEVICES" not in os.environ
                      and _local_cards() >= args.num_workers)
    if args.launcher == "ssh":
        if not args.hostfile:
            ap.error("the ssh launcher needs -H hostfile")
        for c in ssh_commands(args, command):
            print(" ".join(shlex.quote(x) for x in c))
        return 0
    return launch_local(args, command)


if __name__ == "__main__":
    sys.exit(main())
