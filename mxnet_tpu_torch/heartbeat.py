"""Worker liveness: heartbeats and the pre-collective gate.

Counterpart of ``mxnet_tpu/heartbeat.py``, with its file format, its
environment names and its protocol, so a JAX worker and a port worker
read each other's files (parity: the reference's
``KVStore::get_num_dead_node(node_id, timeout)`` over ps-lite scheduler
heartbeats, include/mxnet/kvstore.h:338). There is no scheduler
process: liveness rides a shared directory. Each worker's daemon thread
rewrites ``{MXTPU_HEARTBEAT_DIR}/worker-{rank}`` every ``interval``
seconds (atomically: a temporary file, then a rename), and any process
counts the peers whose file is stale. ``python -m
mxnet_tpu_torch.launch --heartbeat-dir`` provisions the directory and
exports ``MXTPU_HEARTBEAT_DIR``/``_INTERVAL``/``_TIMEOUT``.

:class:`CollectiveGate` is a barrier-file protocol every worker crosses
BEFORE a cross-process collective: a peer that never arrives and whose
heartbeat has gone stale raises :class:`DeadWorkerError` naming the
dead ranks, so the survivors abort the step they never entered (a gloo
collective with a dead peer would otherwise error out or hang), re-mesh
over the live membership and resume from the last checkpoint
(``Module.fit``'s elastic path). Two fault sites ride here:
``kv_collective`` (fired at every gate crossing, before the arrival is
published: a deterministic kill point) and ``heartbeat`` (fired at every
beat: a raise kills the beat thread, a worker that computes on but
reads as dead).

Staleness is judged against the FILESYSTEM's clock, not the reader's:
ages compare a worker file's mtime to the mtime of a probe file the
reader just wrote into the same directory, so a reader whose wall clock
is skewed from the file server neither reads live peers as dead nor dead
ones as live. The beat payload's ``time.time()`` text is informational.

Without a directory, or without a peer, the gate is disabled: a crossing
fires the fault site and counts its generation, nothing else.
"""
from __future__ import annotations

import os
import re
import threading
import time
import weakref

from .base import MXNetError

__all__ = ["start_heartbeat", "stop_heartbeat", "count_dead",
           "alive_ranks", "stale_ranks", "CollectiveGate",
           "DeadWorkerError", "gate_stats"]

ENV_DIR = "MXTPU_HEARTBEAT_DIR"
ENV_INTERVAL = "MXTPU_HEARTBEAT_INTERVAL"
ENV_TIMEOUT = "MXTPU_HEARTBEAT_TIMEOUT"
ENV_GATE_TIMEOUT = "MXTPU_GATE_TIMEOUT"
ENV_STRAGGLER_MS = "MXTPU_STRAGGLER_MS"
ENV_STRAGGLER_K = "MXTPU_STRAGGLER_K"
DEFAULT_INTERVAL = 1.0
DEFAULT_TIMEOUT = 10.0
# a peer missing from the gate whose heartbeat stays FRESH is slow
# (compiling, GC pause), not dead — wait for it up to this hard cap
DEFAULT_GATE_TIMEOUT = 300.0
# straggler verdict: the last arriver is a straggler when its arrival
# trails the fleet median by >= this many ms for K consecutive
# crossings of the same channel (one slow step is noise; a streak is
# a rank the planner should act on)
DEFAULT_STRAGGLER_MS = 50.0
DEFAULT_STRAGGLER_K = 3

# every live gate, so the flight sampler can fold per-channel wait
# series into its samples without threading gate handles through the
# fit loop (weak: a gate dies with its owner, the registry must not
# pin re-meshed gates alive)
_gates_lock = threading.Lock()
_gates = weakref.WeakSet()      # guarded by: _gates_lock

_WORKER_RE = re.compile(r"^worker-(\d+)$")

_state = {"thread": None, "stop": None, "path": None}


class DeadWorkerError(MXNetError):
    """A cross-process collective was aborted before entry: peer
    worker(s) are missing from the gate and their heartbeats are stale
    (``ranks``), or the gate's hard timeout expired (``timed_out`` with
    the still-missing ranks). ``channel``/``generation`` locate the
    collective; ``epoch``/``nbatch`` are stamped by the fit loop where
    known."""

    def __init__(self, ranks, channel=None, generation=None,
                 timed_out=False, evidence=None):
        self.ranks = tuple(sorted(int(r) for r in ranks))
        self.channel = channel
        self.generation = generation
        self.timed_out = timed_out
        self.evidence = dict(evidence or {})
        self.epoch = None
        self.nbatch = None
        what = ("gate timeout waiting for worker(s) %s (heartbeats still "
                "fresh — raising anyway after the hard cap)"
                if timed_out else
                "worker(s) %s are dead (missing from the gate, heartbeat "
                "stale)")
        ev = ""
        if self.evidence:
            ev = " evidence: " + ", ".join(
                "rank %s: %s" % (r, e)
                for r, e in sorted(self.evidence.items()))
        super().__init__(
            ("collective aborted before entry: " + what +
             " [channel=%r generation=%s].%s Surviving workers should "
             "re-mesh and resume from the last checkpoint.")
            % (list(self.ranks), channel, generation, ev))


def _path(root, rank):
    return os.path.join(root, "worker-%d" % int(rank))


def _interval(interval):
    if interval is not None:
        return float(interval)
    return float(os.environ.get(ENV_INTERVAL, DEFAULT_INTERVAL))


def _timeout(timeout):
    if timeout is not None:
        return float(timeout)
    return float(os.environ.get(ENV_TIMEOUT, DEFAULT_TIMEOUT))


def _unlink_quiet(path):
    """Best-effort removal of a temp artifact on a failure path: a
    failed rename must not leave ``.tmp`` litter on the shared mount
    that peers scan forever."""
    try:
        os.unlink(path)
    except OSError:
        pass


def _fs_now(root):
    """The shared directory's OWN notion of "now": the mtime of a probe
    file this process just wrote there. Comparing worker-file mtimes
    against this (instead of the reader's ``time.time()``) makes
    staleness immune to wall-clock skew between the reader and the
    file server. Falls back to the local clock when the directory
    is unwritable."""
    probe = os.path.join(root, ".clock-probe-%d" % os.getpid())
    tmp = probe + ".tmp"
    try:
        with open(tmp, "w") as f:
            f.write("probe")
        os.replace(tmp, probe)
        return os.path.getmtime(probe)
    except OSError:
        # a failed rename must not leave the probe's .tmp behind on
        # the shared mount: leftover artifacts are exactly what the
        # scanner has to defend against
        _unlink_quiet(tmp)
        return time.time()


def start_heartbeat(rank, root=None, interval=None):
    """Start (idempotently) the daemon heartbeat for this process."""
    root = root or os.environ.get(ENV_DIR)
    if not root or _state["thread"] is not None:
        return
    os.makedirs(root, exist_ok=True)
    path = _path(root, rank)
    stop = threading.Event()
    interval = _interval(interval)

    def beat():
        # ATOMIC beat: write temp + rename. The old open(path, "w")
        # truncated in place, so a concurrent staleness read could stat
        # the file mid-rewrite and read a zero-length/zero-mtime worker
        # as dead — on shared filesystems (NFS/GCS fuse, exactly where
        # this runs) the truncate→write window is milliseconds wide.
        from . import faults
        tmp = path + ".tmp"
        while not stop.is_set():
            # chaos site: a raise kills THIS thread — the worker keeps
            # computing but its file goes stale, the zombie the liveness
            # tier must treat as dead; delay= stretches the beat gap
            faults.fire("heartbeat")
            try:
                with open(tmp, "w") as f:
                    f.write(str(time.time()))
                os.replace(tmp, path)
            except OSError:
                # a beat that failed between create and rename must
                # not leave its .tmp behind: a worker that then DIES
                # would leak the artifact onto the shared mount
                # forever (stop_heartbeat only cleans a clean stop)
                _unlink_quiet(tmp)
            stop.wait(interval)

    t = threading.Thread(target=beat, daemon=True,
                         name="mxtpu-heartbeat-%d" % int(rank))
    t.start()
    _state["thread"] = t
    _state["stop"] = stop
    _state["path"] = path


def stop_heartbeat():
    """Stop the beat AND remove this worker's file: a cleanly-stopped
    worker must read as departed immediately, not linger as a stale
    file that counts dead for ``timeout`` seconds first."""
    if _state["stop"] is None:
        return
    _state["stop"].set()
    thread, path = _state["thread"], _state["path"]
    _state["thread"] = None
    _state["stop"] = None
    _state["path"] = None
    if thread is not None:
        # the beat loop wakes immediately on the event; join so a
        # final in-flight rename cannot resurrect the file after the
        # removal below
        thread.join(timeout=5.0)
    if path is not None:
        for p in (path, path + ".tmp"):
            try:
                os.remove(p)
            except OSError:
                pass


def _scan(root, timeout):
    """ONE pass over the heartbeat directory: ``(alive_set, ages)``
    with a single probe write (every caller needing both freshness and
    evidence ages shares it — per-poll double probe writes would be
    sustained metadata churn on exactly the NFS/GCS mounts this
    targets). Scans exact ``worker-<N>`` names — a leftover
    ``worker-N.tmp`` from a writer that died mid-rename (or any other
    stray file) is ignored — and judges freshness against the
    directory's own clock (see :func:`_fs_now`)."""
    try:
        names = os.listdir(root)
    except OSError:
        return set(), {}
    now = _fs_now(root)
    alive, ages = set(), {}
    for name in names:
        m = _WORKER_RE.match(name)
        if not m:
            continue
        try:
            age = now - os.path.getmtime(os.path.join(root, name))
        except OSError:
            continue
        ages[int(m.group(1))] = age
        if age <= timeout:
            alive.add(int(m.group(1)))
    return alive, ages


def alive_ranks(root=None, timeout=None):
    """Set of worker ranks with a FRESH heartbeat file (see
    :func:`_scan` for the clock and ``.tmp`` discipline)."""
    root = root or os.environ.get(ENV_DIR)
    if not root:
        return set()
    return _scan(root, _timeout(timeout))[0]


def stale_ranks(ranks, root=None, timeout=None):
    """The subset of ``ranks`` whose heartbeat file is missing or
    stale (same clock discipline as :func:`alive_ranks`)."""
    root = root or os.environ.get(ENV_DIR)
    if not root:
        return []
    alive = alive_ranks(root=root, timeout=timeout)
    return [int(r) for r in ranks if int(r) not in alive]


def count_dead(num_workers, root=None, timeout=None):
    """Number of workers in ``range(num_workers)`` whose heartbeat is
    missing or older than ``timeout`` seconds (parity:
    get_num_dead_node). Staleness is judged against the heartbeat
    directory's own clock and leftover ``*.tmp`` artifacts never count
    as live workers."""
    root = root or os.environ.get(ENV_DIR)
    if not root:
        return 0
    return len(stale_ranks(range(int(num_workers)), root=root,
                           timeout=timeout))


class CollectiveGate:
    """Bounded-timeout barrier-file protocol crossed BEFORE every
    cross-process collective.

    Each member owns ONE file per channel
    (``gate-<channel>-<members>/rank-<r>``) holding its latest
    generation number, rewritten atomically each crossing — no per-step
    file accumulation. ``arrive_and_wait()`` bumps the local
    generation, publishes it, and polls until every peer's published
    generation reaches it (a peer racing ahead has necessarily passed
    this generation). A peer that has not arrived is judged by its
    HEARTBEAT: stale → :class:`DeadWorkerError` naming the dead ranks
    (the caller aborts the step it never entered — nothing hangs);
    fresh → keep waiting (slow ≠ dead) up to the hard cap
    (``MXTPU_GATE_TIMEOUT``), then raise with ``timed_out=True``.

    The directory name embeds the member set, so a re-meshed group
    (after a member loss) opens a fresh namespace and the dead peer's
    old generation file cannot satisfy a new-generation wait.

    The ``kv_collective`` fault site fires at every crossing BEFORE the
    arrival is published: an injected raise kills this worker at a
    deterministic collective index and its peers observe exactly what a
    real mid-training death looks like — an absent arrival and a
    heartbeat going stale.
    """

    def __init__(self, rank, members, root=None, channel="step",
                 timeout=None, gate_timeout=None, poll=0.05):
        self.rank = int(rank)
        self.members = tuple(sorted(int(m) for m in members))
        self.channel = str(channel)
        self.root = root or os.environ.get(ENV_DIR)
        self.timeout = _timeout(timeout)
        self.gate_timeout = float(
            gate_timeout if gate_timeout is not None
            else os.environ.get(ENV_GATE_TIMEOUT, DEFAULT_GATE_TIMEOUT))
        self.poll = float(poll)
        # the gate's mutable state is shared the moment a gate object
        # is reachable from more than one thread (an elastic-recovery
        # watcher reading .generation while the fit thread crosses)
        self._lock = threading.Lock()
        self.generation = 0     # guarded by: self._lock
        # ranks whose heartbeat this gate has EVER observed: a missing
        # file is only evidence of death for a peer we once saw — a
        # slow joiner (still importing while we cross the first
        # gate) has no file yet and must not read as dead
        self._seen = set()      # guarded by: self._lock
        self.straggler_ms = float(os.environ.get(
            ENV_STRAGGLER_MS, DEFAULT_STRAGGLER_MS))
        self.straggler_k = max(1, int(os.environ.get(
            ENV_STRAGGLER_K, DEFAULT_STRAGGLER_K)))
        # consecutive-crossing count for the CURRENT worst rank only —
        # a different rank arriving last resets the streak (the verdict
        # is "one rank is persistently slow", not "steps are slow")
        self._streak = [None, 0]        # guarded by: self._lock
        self._stats = {                 # guarded by: self._lock
            "crossings": 0, "wait_ms_total": 0.0, "last_wait_ms": 0.0,
            "last_rank": None, "last_excess_ms": 0.0, "stragglers": 0,
        }
        # step-time skew bookkeeping: wall time between crossings minus
        # the waits the caller reported (note_wait) = this rank's OWN
        # work, published in the gate file so every rank can compare
        # self-times fleet-wide. A straggler whose slowness hides
        # behind a synchronizing collective (peers absorb it in their
        # completion await, arriving at the next gate together) is
        # invisible to arrival order but NOT to self-time.
        self._ext_wait_ms = 0.0         # guarded by: self._lock
        self._last_return = None        # guarded by: self._lock
        self._dir = None
        if self.root:
            tag = "-".join(str(m) for m in self.members)
            self._dir = os.path.join(
                self.root, "gate-%s-%s" % (self.channel, tag))
        with _gates_lock:
            _gates.add(self)

    @property
    def enabled(self):
        """The file protocol needs the shared heartbeat directory and a
        peer to guard against; otherwise crossings are (fault-site
        consults followed by) no-ops."""
        return self._dir is not None and len(self.members) > 1

    def _member_path(self, rank):
        return os.path.join(self._dir, "rank-%d" % int(rank))

    def note_wait(self, ms):
        """Report time this rank spent WAITING between crossings (the
        fit loop calls this with its collective-completion await). The
        reported waits are subtracted from the inter-crossing wall time
        so the self-time published at the next arrival reflects this
        rank's OWN work only — a rank stalled waiting on a slow peer
        must not itself read as slow."""
        with self._lock:
            self._ext_wait_ms += max(0.0, float(ms))

    def _take_self_ms(self):
        """Self-time for the crossing about to be published: wall time
        since the previous crossing returned, minus the waits the
        caller reported via :meth:`note_wait`. ``None`` on the first
        crossing (no window yet). Resets the window."""
        now = time.monotonic()
        with self._lock:
            last, ext = self._last_return, self._ext_wait_ms
            self._ext_wait_ms = 0.0
        if last is None:
            return None
        return max(0.0, (now - last) * 1e3 - ext)

    def _publish(self, gen, self_ms=None):
        os.makedirs(self._dir, exist_ok=True)
        path = self._member_path(self.rank)
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                # "<gen> <local wall time> <self_ms>": the generation
                # is the protocol; the timestamp is the informational
                # half of the arrival record (arrival ORDER is judged
                # by file mtimes — the shared filesystem's own clock,
                # the only one comparable across hosts; see _fs_now);
                # self_ms is this rank's own-work time since its last
                # crossing ("-" on the first), the fleet-comparable
                # step-time-skew signal every peer reads back
                f.write("%d %.6f %s"
                        % (int(gen), time.time(),
                           "-" if self_ms is None else "%.3f" % self_ms))
            os.replace(tmp, path)
        except BaseException:
            # gate-publish failure is fatal to the crossing (the
            # caller raises), but the .tmp must not linger on the
            # shared mount — peers scan this directory forever
            _unlink_quiet(tmp)
            raise

    def _peer_gen(self, rank):
        try:
            with open(self._member_path(rank)) as f:
                head = f.read().split()
                return int(head[0]) if head else 0
        except (OSError, ValueError):
            return -1

    def _arrivals(self, gen):
        """Arrival record for generation ``gen``, read back from the
        gate files every rank just published: ``[(rank, mtime,
        self_ms)]`` where ``mtime`` is the arrival time on the shared
        filesystem's clock (cross-host comparable — the same clock
        staleness is judged by) and ``self_ms`` is the own-work time
        that rank published with its arrival (None when absent). A
        member whose file already shows a LATER generation raced
        ahead — it certainly arrived at ``gen`` before us, but its
        mtime/self-time now reflect the later publish, so it carries
        ``mtime=None`` and is excluded from timing verdicts."""
        out = []
        for m in self.members:
            path = self._member_path(m)
            try:
                with open(path) as f:
                    head = f.read().split()
                g = int(head[0]) if head else 0
                mt = os.path.getmtime(path)
            except (OSError, ValueError):
                continue
            self_ms = None
            if len(head) > 2 and head[2] != "-":
                try:
                    self_ms = float(head[2])
                except ValueError:
                    pass
            if g == gen:
                out.append((int(m), mt, self_ms))
            elif g > gen:
                out.append((int(m), None, None))
        return out

    def _record_crossing(self, gen, t0_ns, error=None):
        """Attribute one finished (or aborted) crossing: a
        ``gate_wait`` span whose ctx names who arrived last and by how
        much, per-channel wait/crossing counters, running stats for the
        flight sampler, and the streak machine behind the structured
        ``dist.straggler`` event. Attribution must never take down a
        step the barrier itself completed — any surprise here is
        swallowed after stamping the stats.

        TWO skew signals feed one verdict, because a straggler can hide
        either way: (a) arrival-order excess — the last arrival's mtime
        vs the fleet's lower-median arrival (catches slow input/compute
        BEFORE the gate); (b) self-time excess — the max published
        self-time vs its lower median (catches slowness a synchronizing
        collective absorbed: peers blocked in the completion await
        arrive at the next gate TOGETHER, so arrival order reads ~0
        skew while the straggler's own-work time is the step's whole
        budget). The verdict takes whichever signal shows the larger
        excess."""
        from . import telemetry
        with self._lock:
            # close the self-time window at the crossing's end, enabled
            # or not: the next publish measures from here
            self._last_return = time.monotonic()
        if not telemetry.enabled():
            return
        t1_ns = time.perf_counter_ns()
        wait_ms = (t1_ns - t0_ns) / 1e6
        last_rank, excess_ms, order = None, 0.0, []
        try:
            arrivals = self._arrivals(gen)
            timed = sorted((mt, r) for r, mt, _s in arrivals
                           if mt is not None)
            if timed:
                first_mt = timed[0][0]
                order = [[r, round((mt - first_mt) * 1e3, 3)]
                         for mt, r in timed]
                last_mt, last_rank = timed[-1]
                # lower median of the (sorted) arrival times: with 2
                # ranks the excess is simply last-vs-first; with more,
                # one early outlier cannot inflate the verdict
                mid = timed[(len(timed) - 1) // 2][0]
                excess_ms = max(0.0, (last_mt - mid) * 1e3)
            selfs = sorted((s, r) for r, mt, s in arrivals
                           if mt is not None and s is not None)
            self_map = {r: round(s, 3) for s, r in selfs}
            if len(selfs) > 1:
                slow_ms, slow_rank = selfs[-1]
                skew_ms = max(
                    0.0, slow_ms - selfs[(len(selfs) - 1) // 2][0])
                if skew_ms > excess_ms:
                    last_rank, excess_ms = slow_rank, skew_ms
            if error is not None:
                # the crossing never completed: the wait is the dead
                # rank's fault in full — this is the pre-death spike
                # fleet_view pins on the victim
                last_rank = int(error.ranks[0])
                excess_ms = wait_ms
            ctx = dict(telemetry.current_causal() or {})
            ctx.update({"channel": self.channel, "generation": gen,
                        "wait_ms": round(wait_ms, 3)})
            if last_rank is not None:
                ctx["last_rank"] = last_rank
                ctx["excess_ms"] = round(excess_ms, 3)
            if order:
                ctx["arrivals"] = order
            if self_map:
                ctx["self_ms"] = self_map
            if error is not None:
                ctx["dead_ranks"] = list(error.ranks)
                ctx["timed_out"] = bool(error.timed_out)
            telemetry.record_span("gate_wait", t0_ns, t1_ns, ctx)
            telemetry.counter_inc(
                "heartbeat.gate_crossings.%s" % self.channel)
            telemetry.counter_inc(
                "heartbeat.gate_wait_ms.%s" % self.channel,
                round(wait_ms, 3))
            emit = 0
            with self._lock:
                st = self._stats
                st["crossings"] += 1
                st["wait_ms_total"] += wait_ms
                st["last_wait_ms"] = wait_ms
                st["last_rank"] = last_rank
                st["last_excess_ms"] = excess_ms
                if error is None and last_rank is not None \
                        and excess_ms >= self.straggler_ms:
                    if self._streak[0] != last_rank:
                        self._streak = [last_rank, 0]
                    self._streak[1] += 1
                    if self._streak[1] >= self.straggler_k:
                        emit = self._streak[1]
                        st["stragglers"] += 1
                else:
                    self._streak = [None, 0]
            if emit:
                telemetry.record_event(
                    "dist.straggler", rank=last_rank,
                    channel=self.channel, generation=gen,
                    excess_ms=round(excess_ms, 3),
                    wait_ms=round(wait_ms, 3), streak=emit)
                telemetry.counter_inc("dist.straggler")
        except Exception:
            pass

    def stats(self):
        """Point-in-time copy of this gate's crossing stats (the
        flight sampler's per-channel series source)."""
        with self._lock:
            return dict(self._stats)

    def arrive_and_wait(self):
        """Cross the gate for the next collective. Returns the
        generation entered; raises :class:`DeadWorkerError` instead of
        letting the caller enter a collective a dead peer can never
        join."""
        from . import faults
        # the chaos kill point: BEFORE publishing the arrival, so a
        # killed worker is missing from this generation on every peer
        faults.fire("kv_collective")
        with self._lock:
            self.generation += 1
            gen = self.generation
        if not self.enabled:
            return gen
        self._publish(gen, self_ms=self._take_self_ms())
        t0_ns = time.perf_counter_ns()
        deadline = time.monotonic() + self.gate_timeout
        peers = [m for m in self.members if m != self.rank]
        # liveness verdicts need a directory scan + probe write — keep
        # those to a few per second even while the arrival files poll
        # fast (a slow-but-live peer can keep us here for minutes)
        liveness_every = max(self.poll, 0.25)
        next_liveness = time.monotonic()
        while True:
            missing = [p for p in peers if self._peer_gen(p) < gen]
            if not missing:
                self._record_crossing(gen, t0_ns)
                return gen
            if time.monotonic() >= next_liveness:
                next_liveness = time.monotonic() + liveness_every
                dead = self._dead_among(missing)
                if dead:
                    err = DeadWorkerError([r for r, _ in dead],
                                          channel=self.channel,
                                          generation=gen,
                                          evidence=dict(dead))
                    self._record_crossing(gen, t0_ns, error=err)
                    raise err
            if time.monotonic() > deadline:
                err = DeadWorkerError(missing, channel=self.channel,
                                      generation=gen, timed_out=True)
                self._record_crossing(gen, t0_ns, error=err)
                raise err
            time.sleep(self.poll)

    def _dead_among(self, ranks):
        """``[(rank, evidence), ...]`` for the subset of ``ranks`` with
        EVIDENCE of death: a stale existing heartbeat file (beats
        stopped), or no file for a peer this gate has seen before
        (crashed-and-cleaned or departed). A never-seen peer with no
        file is a slow joiner — startup skew under load is not death;
        the hard ``gate_timeout`` bounds how long we extend that
        benefit of the doubt. The evidence string (file age vs the
        directory clock) rides in the error: a false-positive report
        must be diagnosable from one log line."""
        alive, ages = _scan(self.root, self.timeout)
        with self._lock:
            self._seen |= alive
            seen = set(self._seen)
        dead = []
        for r in ranks:
            if int(r) in alive:
                continue
            age = ages.get(int(r))
            if age is not None:
                if age > self.timeout:
                    dead.append((int(r),
                                 "heartbeat file %.2fs stale (timeout "
                                 "%.2fs)" % (age, self.timeout)))
                # a fresh-but-not-alive age cannot happen from one
                # scan; kept for clarity: fresh means not dead
            elif int(r) in seen:
                dead.append((int(r), "heartbeat file removed after "
                                     "being seen alive"))
        return dead


def gate_stats():
    """Per-channel crossing stats over every live gate in this
    process — what the flight sampler folds into its series samples
    (``gate.<channel>.*`` keys) and what the fleet summary reads off a
    rank's dump. Two gates on one channel (a re-mesh in flight) merge
    by summing totals and keeping the most-recently-crossed gate's
    ``last_*`` verdicts."""
    with _gates_lock:
        gates = list(_gates)
    out = {}
    for g in gates:
        s = g.stats()
        if not s["crossings"]:
            continue
        cur = out.get(g.channel)
        if cur is None:
            out[g.channel] = s
        else:
            keep_last = s if s["crossings"] >= cur["crossings"] else cur
            merged = {
                "crossings": cur["crossings"] + s["crossings"],
                "wait_ms_total": (cur["wait_ms_total"]
                                  + s["wait_ms_total"]),
                "stragglers": cur["stragglers"] + s["stragglers"],
                "last_wait_ms": keep_last["last_wait_ms"],
                "last_rank": keep_last["last_rank"],
                "last_excess_ms": keep_last["last_excess_ms"],
            }
            out[g.channel] = merged
    return out
