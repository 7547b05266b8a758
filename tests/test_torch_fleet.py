"""The fleet view over the port's flight dumps: two worker processes of
the port share one flight directory and one heartbeat directory, cross a
``step`` gate six times with rank 1 arriving 100 ms late each time, then
rank 1 dies through ``dist.abort`` (its ``worker_abort`` dump) and rank
0's next crossing raises ``DeadWorkerError`` (its ``dead_worker`` dump,
with the peers' dumps gathered). ``tools/fleet_view.py`` (stdlib only,
unchanged) reads the directory: rank 1 named dead and blamed as the
straggler, the two clocks aligned within one liveness poll (0.25 s), the
merged trace one track a rank, and a corrupt dump reported as a named
warning without failing the view.
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r'''
import os, sys, time
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import dist, flight, heartbeat, telemetry
rank, hb, fdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
telemetry.enable()
flight.configure(fdir)
heartbeat.start_heartbeat(rank, root=hb, interval=0.1)
gate = heartbeat.CollectiveGate(rank, (0, 1), root=hb, timeout=1.5,
                                poll=0.01, channel="step")
for i in range(6):
    if rank == 1:
        time.sleep(0.1)
    gate.arrive_and_wait()
if rank == 1:
    dist.abort(17)
try:
    gate.arrive_and_wait()
    sys.exit(3)
except heartbeat.DeadWorkerError as e:
    flight.postmortem("dead_worker", exc=e, extra={
        "dead_ranks": list(e.ranks), "channel": e.channel,
        "generation": e.generation, "survivor_rank": rank,
        "peer_postmortems": flight.gather_peer_postmortems()})
flight.uninstall()
'''


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    base = tmp_path_factory.mktemp("fleet")
    hb, fdir = base / "hb", base / "flight"
    hb.mkdir()
    fdir.mkdir()
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, PYTHONPATH=ROOT, DMLC_RANK=str(rank),
                   DMLC_NUM_WORKER="2", OMP_NUM_THREADS="1")
        for k in ("MXNET_FAULTS", "MXNET_FLIGHT_DIR", "MXNET_TPU_COORDINATOR"):
            env.pop(k, None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(rank), str(hb), str(fdir)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=120)[0] for p in procs]
    rcs = [p.returncode for p in procs]
    assert rcs == [0, 17], (rcs, [o[-3000:] for o in outs])
    # a half-written dump of a third rank
    (fdir / "postmortem-r2-999-001-worker_abort.json").write_text('{"sch')
    trace = base / "trace.json"
    res = subprocess.run([sys.executable,
                          os.path.join(ROOT, "tools", "fleet_view.py"),
                          str(fdir), "--json", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout), res.stderr, trace


def test_fleet_names_the_dead_rank(fleet):
    summary, _, _ = fleet
    assert summary["n_ranks"] == 2
    assert summary["dead_ranks"] == [1]


def test_fleet_blames_the_straggler(fleet):
    summary, _, _ = fleet
    top = summary["stragglers"][0]
    assert top["rank"] == 1, summary["stragglers"]
    assert top["straggler_events"] > 0
    assert top["blamed_crossings"] >= 4


def test_fleet_aligns_the_clocks(fleet):
    summary, _, trace = fleet
    offs = summary["clock"]["offsets_s"]
    assert offs and all(abs(o) <= 0.25 for o in offs.values()), offs
    assert any(int(m) > 0 for r, m in
               summary["clock"]["matched_crossings"].items()
               if int(r) != 0), summary["clock"]
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    tracks = {e["pid"] for e in events if e.get("name") == "process_name"}
    assert tracks >= {0, 1}, tracks


def test_fleet_reports_a_corrupt_dump_by_name(fleet):
    summary, stderr, _ = fleet
    warned = " ".join(summary["warnings"]) + stderr
    assert "postmortem-r2-999-001-worker_abort.json" in warned
