"""Two-process fleet harness: ``python -m metrics_tpu_torch.engine.fleet.harness``.

Port of ``metrics_tpu/engine/fleet/harness.py``: two OS processes on one
machine, a :class:`~metrics_tpu_torch.engine.fleet.FleetEngine` each over
gloo on local sockets (the protocol, not an interconnect: no rate here is a
network's). Seeded Zipf traffic (``engine/traffic.py``, dyadic values) is
the shared plan; each host serves the streams ``sid % 2`` homes on it,
through a one-device deferred local mesh on the CPU (a round's spec may
name a card instead: ``run_pair(..., device="cuda:0")`` puts both hosts on
it, over gloo). The parent checks, from the
artifacts the workers write:

1. **Oracle parity**: every stream's ``results()`` on EITHER host is
   bit-identical to a single-process engine serving the plan.
2. **Same-seed determinism**: each worker serves the plan on two fresh
   fleets; per host, the results and the recorder's
   ``canonical_sequence()`` are identical.
3. **Closed capture set**: a reset and a full replay capture nothing new.
4. **Collective placement**: ``collective_counts()`` stays 0 over the
   steady steps of a replay and is >= 1 over a boundary fold.
5. **Kill one host, restore, exact replay**: host 1 dies past a cut
   (``os._exit``); both hosts restore from the last CONSISTENT cut, replay
   the rest of the plan and equal the oracle bit for bit.
6. **OpenMetrics**: each host's exposition carries the ``host``-labelled
   fleet families; the single-process oracle's carries none.
7. **Tenancy**: the same plan on stream-sharded hosts whose paged arenas
   hold RESIDENT slots against S/2 home streams, under a tumbling window
   rotating at cut-aligned plan positions: bit-exact against the windowed
   oracle through spills, no new capture, the ``leg``-labelled payload and
   spill families, and a kill -> restore -> replay past a spill.

Three rounds of two workers (serve, kill, restore; the plain and the
tenancy fleets share each round). The parent bounds each round's wall time
and kills any worker still alive when it ends; a worker exits with
``os._exit`` once its artifact is written, so a wedged process-group
teardown never outlives its round. Workers import nothing of JAX.

Prints one PASS line; exits non-zero on any violated claim.
"""
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

NUM_HOSTS = 2
S = 16  # streams, homed sid % 2
N_BATCHES = 120  # the shared plan's length
BUCKETS = (16, 32)
CUT_EVERY = 30  # plan batches a snapshot cut
KILL_AT = 75  # the plan position where host 1 dies (past cut 1, at 60)
SEED = 23
KILL_EXIT = 17  # the simulated death's exit code
ROUND_TIMEOUT_S = 300.0
RESIDENT = 3  # tenancy: paged slots a host, against S / 2 home streams
PANE_BATCHES = 60  # tenancy: a tumbling pane, a multiple of CUT_EVERY
N_PANES = 2
WORKER_THREADS = 2  # torch intra-op threads a worker
_REPO = Path(__file__).resolve().parents[3]


def _collection(device: str = "cpu") -> Any:
    from metrics_tpu_torch import Accuracy, MeanSquaredError, MetricCollection

    return MetricCollection([Accuracy(device=device), MeanSquaredError(device=device)])


def traffic() -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """The shared plan: ``(stream_id, preds, target)`` batches."""
    from metrics_tpu_torch.engine.traffic import zipf_traffic

    return zipf_traffic(S, N_BATCHES, alpha=1.1, seed=SEED)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def jsonable_results(results: Dict[int, Any]) -> Dict[str, Dict[str, Any]]:
    return {str(sid): {k: np.asarray(v).tolist() for k, v in tree.items()} for sid, tree in results.items()}


def results_equal(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    """Bitwise per-stream equality, NaN equal to NaN (a stream the Zipf tail
    never touched computes 0/0 on both sides)."""
    if set(a) != set(b):
        return False
    return all(set(a[s]) == set(b[s]) and all(
        np.array_equal(np.asarray(a[s][k]), np.asarray(b[s][k]), equal_nan=True) for k in a[s]) for s in a)


# ---------------------------------------------------------------------- worker


def _build_fleet(spec: Dict[str, Any], pid: int, tenancy: bool, trace: Any = None, snapshot_dir: Any = None) -> Any:
    from metrics_tpu_torch.engine import EngineConfig, WindowPolicy
    from metrics_tpu_torch.engine.fleet import FleetConfig, FleetEngine
    from metrics_tpu_torch.parallel.mesh import Mesh

    device = spec.get("device", "cpu")
    window = WindowPolicy.tumbling(pane_batches=PANE_BATCHES, n_panes=N_PANES) if tenancy else None
    ecfg = EngineConfig(buckets=BUCKETS, coalesce=int(spec.get("coalesce", 1)), mesh=Mesh([device], ("dp",)),
                        axis="dp", mesh_sync="deferred", window=window, trace=trace)
    return FleetEngine(_collection(device), FleetConfig(
        num_processes=NUM_HOSTS, process_id=pid, coordinator_address=spec["coord"], engine=ecfg, num_streams=S,
        stream_shard=tenancy, resident_streams=RESIDENT if tenancy else 0, snapshot_dir=snapshot_dir,
        snapshot_every=CUT_EVERY if snapshot_dir else 0))


def _serve_once(spec: Dict[str, Any], pid: int, tenancy: bool) -> Dict[str, Any]:
    """One fresh fleet: the plan, a reset, the plan again; its artifact."""
    from metrics_tpu_torch.engine import TraceRecorder
    from metrics_tpu_torch.parallel.collectives import collective_counts, reset_collective_counts

    rec = TraceRecorder(capacity=1 << 15, device=spec.get("device", "cpu"))
    fleet = _build_fleet(spec, pid, tenancy, trace=rec)
    plan = traffic()
    with fleet:
        for b in plan:
            fleet.ingest(*b)
        first = fleet.results()
        warm = fleet.engine.aot_cache.misses
        fleet.reset()
        reset_collective_counts()
        for b in plan:
            fleet.ingest(*b)
        fleet.flush()
        steady = collective_counts()
        reset_collective_counts()
        second = fleet.results()
        fold = collective_counts()
        new_captures = fleet.engine.aot_cache.misses - warm
    r1, r2 = jsonable_results(first), jsonable_results(second)
    return {
        "results": r1,
        "repeat_equal": results_equal(r1, r2),
        "steady_compiles": int(new_captures),
        "steady_collectives": steady,
        "fold_collectives": fold,
        "dropped_spans": int(rec.dropped),
        "spans": json.loads(json.dumps(rec.canonical_sequence(), default=str)),
        "metrics_text": fleet.metrics_text(),
        "fleet_block": fleet.telemetry().get("fleet"),
        "rotations": int(fleet.engine.stats.pane_rotations),
    }


def _scenario_serve(spec: Dict[str, Any], pid: int, out: Dict[str, Any]) -> None:
    """Per form (plain, tenancy): two fresh fleets, each the plan twice."""
    for form in ("plain", "tenancy"):
        out[form] = [_serve_once(spec, pid, form == "tenancy") for _ in range(2)]


def _snap_dir(spec: Dict[str, Any], form: str) -> str:
    return os.path.join(spec["snapshot_dir"], form)


def _scenario_kill(spec: Dict[str, Any], pid: int, out: Dict[str, Any]) -> None:
    """Both forms serve to KILL_AT (cuts at 30 and 60), then host 1 DIES: no
    result, no teardown. Host 0 stops at the same position (a fleet that
    lost a host cannot cross its next barrier) and exits cleanly."""
    plan = traffic()
    for form in ("plain", "tenancy"):
        fleet = _build_fleet(spec, pid, form == "tenancy", snapshot_dir=_snap_dir(spec, form))
        with fleet:
            for b in plan[:KILL_AT]:
                fleet.ingest(*b)
            fleet.flush()
            pager = fleet.engine.pager
            out[form] = {"cursor": fleet.global_cursor, "cuts": fleet.engine.stats.fleet_cuts,
                         "spilled_rows": int(pager.tenancy_stats()["spilled_rows"]) if pager is not None else 0}
    if pid == 1:
        # the death: the artifact must be durable first, os._exit skips every flush
        with open(spec["out_paths"][pid], "w") as f:
            json.dump(out, f)
        os._exit(KILL_EXIT)


def _scenario_restore(spec: Dict[str, Any], pid: int, out: Dict[str, Any]) -> None:
    """Both forms restore from the last CONSISTENT cut and replay the rest of
    the plan."""
    plan = traffic()
    for form in ("plain", "tenancy"):
        fleet = _build_fleet(spec, pid, form == "tenancy", snapshot_dir=_snap_dir(spec, form))
        meta = fleet.restore()
        with fleet:
            for b in plan[fleet.global_cursor:]:
                fleet.ingest(*b)
            results = jsonable_results(fleet.results())
            pager = fleet.engine.pager
            out[form] = {"restored_cut": int(meta.get("fleet_cut", -1)),
                         "restored_cursor": int(meta.get("fleet_plan_cursor", -1)), "results": results,
                         "spilled_rows": int(pager.tenancy_stats()["spilled_rows"]) if pager is not None else 0}


_SCENARIOS: Dict[str, Callable[[Dict[str, Any], int, Dict[str, Any]], None]] = {
    "serve": _scenario_serve,
    "kill": _scenario_kill,
    "restore": _scenario_restore,
}


def _worker() -> None:
    """A worker's entry: one scenario for one host (on ``spec["device"]``,
    the CPU unless named), the artifact written, then ``os._exit``."""
    import torch

    torch.set_num_threads(WORKER_THREADS)
    with open(os.environ["FLEET_WORKER_SPEC"]) as f:
        spec = json.load(f)
    pid = int(os.environ["FLEET_PROC_ID"])
    if spec.get("device", "cpu").startswith("cuda"):
        torch.cuda.set_device(torch.device(spec["device"]))
    out: Dict[str, Any] = {"pid": pid}
    rc = 0
    try:
        _SCENARIOS[spec["scenario"]](spec, pid, out)
    except BaseException:  # noqa: BLE001 - the artifact carries the failure
        out["error"] = traceback.format_exc()
        rc = 1
    import torch.distributed as dist

    out["backend"] = dist.get_backend() if dist.is_initialized() else None
    out["imported_jax"] = any(m == "jax" or m.startswith(("jax.", "metrics_tpu.")) or m == "metrics_tpu"
                              for m in sys.modules)
    with open(spec["out_paths"][pid], "w") as f:
        json.dump(out, f)
    os._exit(rc)


# ---------------------------------------------------------------------- parent


def run_pair(scenario: str, workdir: str, tag: str, **extra: Any) -> Tuple[List[int], List[Dict[str, Any]]]:
    """One two-host round, bounded and orphan-safe: a worker still alive
    when the round ends (deadline, a sibling dead, the parent interrupted)
    is killed before this returns."""
    spec = {"scenario": scenario, "coord": f"tcp://127.0.0.1:{_free_port()}",
            "out_paths": [os.path.join(workdir, f"{tag}_host{p}.json") for p in range(NUM_HOSTS)], **extra}
    spec_path = os.path.join(workdir, f"{tag}_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    code = "from metrics_tpu_torch.engine.fleet.harness import _worker; _worker()"
    procs: List[subprocess.Popen] = []
    rcs: List[int] = []
    try:
        for p in range(NUM_HOSTS):
            env = dict(os.environ, FLEET_WORKER_SPEC=spec_path, FLEET_PROC_ID=str(p),
                       PYTHONPATH=os.pathsep.join([str(_REPO)] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
            procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, cwd=str(_REPO)))
        deadline = time.monotonic() + ROUND_TIMEOUT_S
        for proc in procs:
            rcs.append(proc.wait(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    outs = []
    for path in spec["out_paths"]:
        try:
            with open(path) as f:
                outs.append(json.load(f))
        except (OSError, ValueError):
            outs.append({"error": f"worker artifact missing: {path}"})
    return rcs, outs


def oracles() -> Dict[str, Dict[str, Any]]:
    """The single-process engines serving the plan: plain, and under the
    tenancy's tumbling window; their results and the plain one's
    exposition."""
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, WindowPolicy

    plan = traffic()
    out = {}
    for form, window in (("plain", None), ("tenancy", WindowPolicy.tumbling(pane_batches=PANE_BATCHES,
                                                                           n_panes=N_PANES))):
        eng = MultiStreamEngine(_collection(), S, EngineConfig(buckets=BUCKETS, window=window))
        with eng:
            for sid, p, t in plan:
                eng.submit(sid, p, t)
            out[form] = {"results": jsonable_results(eng.results()), "metrics_text": eng.metrics_text()}
    return out


def run(workdir: str) -> Dict[str, Any]:
    """The three rounds and every claim's check. Returns ``{"failures": [...],
    "serve": ..., "kill": ..., "restore": ..., "oracle": ...}`` (the
    rounds' artifacts by host)."""
    sys.path.insert(0, str(_REPO / "tools"))
    import trace_export

    failures: List[str] = []

    def check(cond: bool, msg: str) -> None:
        if not cond:
            failures.append(msg)

    want = oracles()
    check("fleet_" not in want["plain"]["metrics_text"], "the single-process exposition grew fleet families")
    trace_export.parse_openmetrics(want["plain"]["metrics_text"])
    report: Dict[str, Any] = {"failures": failures, "oracle": want}

    def parity(tag: str, got: Dict[str, Any], form: str) -> None:
        ref = want[form]["results"]
        check(results_equal(got, ref), f"{tag}: results differ from the single-process oracle")

    rcs, serve = run_pair("serve", workdir, "serve")
    report["serve"] = serve
    for p, (rc, o) in enumerate(zip(rcs, serve)):
        check(rc == 0 and "error" not in o, f"serve host {p} failed: rc={rc} {o.get('error', '')[-800:]}")
        check(not o.get("imported_jax", True), f"serve host {p} imported JAX")
    if failures:
        return report
    for p, o in enumerate(serve):
        for form in ("plain", "tenancy"):
            a, b = o[form]
            parity(f"{form} host {p}", a["results"], form)
            check(results_equal(a["results"], b["results"]), f"{form} host {p}: same-seed fleets differ")
            check(a["spans"] == b["spans"], f"{form} host {p}: same-seed canonical span sequences differ")
            check(a["dropped_spans"] == 0, f"{form} host {p}: the trace ring dropped spans")
            for run_ix, r in enumerate((a, b)):
                check(r["repeat_equal"], f"{form} host {p} run {run_ix}: reset and replay differ")
                check(r["steady_compiles"] == 0, f"{form} host {p}: {r['steady_compiles']} captures after warm-up")
                check(not any(r["steady_collectives"].values()),
                      f"{form} host {p}: collectives in the steady steps {r['steady_collectives']}")
                check(sum(r["fold_collectives"].values()) >= 1, f"{form} host {p}: a fold issued no collective")
            fams = trace_export.parse_openmetrics(a["metrics_text"])
            for fam in ("fleet_ingested", "fleet_merges", "fleet_barriers"):
                samples = fams.get(f"metrics_tpu_engine_{fam}", {}).get("samples", [])
                check(any(s.get("labels", {}).get("host") == str(p) for s in samples),
                      f"{form} host {p}: {fam} lacks the host label")
            fb = a["fleet_block"] or {}
            check(fb.get("num_hosts") == NUM_HOSTS and fb.get("process_id") == p, f"host {p} fleet block {fb}")
            check(fb.get("streams_owned") == S // NUM_HOSTS, f"host {p} owns {fb.get('streams_owned')} streams")
            check(fb.get("ingested", 0) > 0 and fb.get("skipped", 0) > 0
                  and fb["ingested"] + fb["skipped"] == 2 * N_BATCHES, f"host {p} ingest split {fb}")
        ten = o["tenancy"][0]
        check(ten["rotations"] == 2 * (N_BATCHES // PANE_BATCHES), f"tenancy host {p} rotated {ten['rotations']}")
        tb = (ten["fleet_block"] or {}).get("tenancy") or {}
        check(0 < tb.get("resident_rows", 0) <= RESIDENT, f"tenancy host {p} resident rows {tb}")
        check(tb.get("spill_rows", 0) > 0 and tb.get("spill_bytes", 0) > 0, f"tenancy host {p} never spilled {tb}")
        fams = trace_export.parse_openmetrics(ten["metrics_text"])
        legs = {s.get("labels", {}).get("leg")
                for s in fams.get("metrics_tpu_engine_fleet_payload_bytes", {}).get("samples", [])}
        check({"intra", "cross"} <= legs, f"tenancy host {p}: payload legs {legs}")

    snapdir = os.path.join(workdir, "fleet_snaps")
    rcs, kill = run_pair("kill", workdir, "kill", snapshot_dir=snapdir, coalesce=8)
    report["kill"] = kill
    check(rcs == [0, KILL_EXIT], f"kill round exit codes {rcs} (wanted [0, {KILL_EXIT}])")
    check("error" not in kill[0], f"surviving host failed: {kill[0].get('error', '')[-800:]}")
    if failures:
        return report
    from metrics_tpu_torch.engine.fleet import last_consistent_cut

    want_cut, want_cursor = KILL_AT // CUT_EVERY - 1, (KILL_AT // CUT_EVERY) * CUT_EVERY
    for form in ("plain", "tenancy"):
        check(kill[0][form]["cuts"] == KILL_AT // CUT_EVERY, f"{form}: {kill[0][form]['cuts']} cuts before the death")
        k = last_consistent_cut(os.path.join(snapdir, form), NUM_HOSTS)
        check(k == want_cut, f"{form}: last consistent cut {k}, expected {want_cut}")
    check(kill[0]["tenancy"]["spilled_rows"] > 0, "tenancy: the death landed before any spill")

    rcs, restore = run_pair("restore", workdir, "restore", snapshot_dir=snapdir, coalesce=8)
    report["restore"] = restore
    for p, (rc, o) in enumerate(zip(rcs, restore)):
        check(rc == 0 and "error" not in o, f"restore host {p} failed: rc={rc} {o.get('error', '')[-800:]}")
    if failures:
        return report
    for p, o in enumerate(restore):
        for form in ("plain", "tenancy"):
            r = o[form]
            check(r["restored_cut"] == want_cut and r["restored_cursor"] == want_cursor,
                  f"{form} host {p} restored cut/cursor {r['restored_cut']}/{r['restored_cursor']}")
            parity(f"post-restore {form} host {p}", r["results"], form)
        check(o["tenancy"]["spilled_rows"] > 0, f"tenancy host {p}: the replay never paged a row")
    return report


def main() -> int:
    workdir = tempfile.mkdtemp(prefix="metrics_tpu_torch_fleet_")
    t0 = time.perf_counter()
    report = run(workdir)
    if report["failures"]:
        for f in report["failures"]:
            print(f"fleet harness FAIL: {f}")
        return 1
    print(
        f"fleet harness PASS: two processes (gloo) served {N_BATCHES} Zipf batches over {S} streams (homed sid % "
        f"{NUM_HOSTS}) bit-identical to the single-process engine on both hosts; two fresh fleets a host "
        "identical in results and canonical spans; no capture after warm-up; 0 collectives in the steady steps, "
        f"the fold's >= 1; cuts every {CUT_EVERY} plan batches; host 1 killed at {KILL_AT}, both hosts restored "
        f"from consistent cut {KILL_AT // CUT_EVERY - 1} and replayed to parity; host-labelled OpenMetrics; "
        f"tenancy: {RESIDENT} resident slots against {S // NUM_HOSTS} home streams under a tumbling window of "
        f"{PANE_BATCHES} plan batches, exact through spills, kill -> restore -> replay past a spill "
        f"({time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
