"""Port parity: fault tolerance (``repro_torch.train.ft`` and
``train.supervisor``) and the training entry point's failure drill
(``repro_torch.launch.train --ckpt-*/--simulate-failure/--die-at-step``)
against the reference.

``plan_remesh`` (``min_model``, ``max_model``, ``predict``,
``prefer_pow2``), ``plan_recovery`` (injected ``choose``/``make_predict``,
forced strategies) and ``StragglerDetector`` (on ``faults.slow_rank_times``)
give the reference's decisions and flags for the same inputs; the
``Supervisor`` classifies, backs off, retries and exhausts its budget, and
``SurvivorPrecompiler`` keeps its contract, as ``tests/test_supervisor.py``
requires of the reference's. ``launch.train`` on the CPU (reduced smollm-360m,
fp32): fsdp on 8 ranks recovers onto tp on 4 at step 4 from the checkpoint
of step 4 (two writes failed and retried, the survivors' program prebuilt,
the restore shard to shard, spans traced) with its 6 losses within
``256 * np.spacing(np.float32(8.0))`` of the uninterrupted run (one ``Pool``
of 8 for the module); one device dies at step 3 (a subprocess: ``launch.train``
exits with ``os._exit``) and a rerun resumes from step 2, its losses the
uninterrupted run's bit for bit; the ``--dry-run --simulate-failure 2``
recovery plan equals the reference's (its one subprocess); and
``--simulate-failure`` without ``--ckpt-dir`` exits with the reference's
message.
"""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from faults import failing, flaky, slow_rank_times
from repro.train import ft as JFT
from repro_torch.dist.pool import Pool
from repro_torch.obs import Metrics, StragglerMonitor
from repro_torch.train import ft as FT
from repro_torch.train.supervisor import (RetryError, RetryPolicy, Supervisor,
                                          SurvivorPrecompiler, classify, pow2_floor)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
TOL = float(256 * np.spacing(np.float32(8.0)))
BASE = ["--arch", "smollm-360m", "--reduced", "--steps", "6", "--batch", "8",
        "--seq", "32", "--dtype", "float32", "--log-every", "10"]


class FakeRecorder:
    def __init__(self):
        self.events = []

    def event(self, name, **attrs):
        self.events.append({"name": name, **attrs})

    def named(self, name):
        return [e for e in self.events if e["name"] == name]


# ---------------------------------------------------------------------------
# ft: the reference's decisions for the same inputs
# ---------------------------------------------------------------------------

def test_plan_remesh_matches_reference():
    predicts = [None, lambda d, m: 0.3 * d + m * m, lambda d, m: abs(d - 2) + 0.01 * m]
    for n in range(1, 70):
        for min_model in (1, 2, 3):
            for max_model in (None, 1, 4):
                for pow2 in (True, False):
                    for pr in predicts:
                        kw = dict(min_model=min_model, max_model=max_model,
                                  predict=pr, prefer_pow2=pow2)
                        a, b = FT.plan_remesh(n, **kw), JFT.plan_remesh(n, **kw)
                        assert (a.mesh_shape, a.axis_names, a.reason) == \
                            (b.mesh_shape, b.axis_names, b.reason), (n, kw)
    for n in range(1, 200):
        assert FT._factorizations(n) == JFT._factorizations(n)
    from repro_torch.launch.mesh import plan_remesh
    assert plan_remesh is FT.plan_remesh


class _Decision:
    strategy = "fsdp_tp"
    reason = "fake ranking"

    def to_dict(self):
        return {"strategy": self.strategy}


@pytest.mark.parametrize("n,strategy", [(6, None), (8, "dp"), (8, "tp"), (4, "fsdp"),
                                        (3, "fsdp_tp"), (1, None)])
def test_plan_recovery_matches_reference(n, strategy):
    calls = {"port": [], "ref": []}

    def hooks(who):
        def choose(cfg, **kw):
            calls[who].append(("choose", kw))
            return _Decision()

        def make_predict(cfg, strategy, **kw):
            calls[who].append(("predict", strategy, kw))
            return lambda d, m: abs(d - 2) + 0.1 * m
        return dict(choose=choose, make_predict=make_predict)

    kw = dict(batch=8, seq=16, strategy=strategy, compute_ref=(0.5, 4))
    a = FT.plan_recovery(object(), n, **kw, **hooks("port"))
    b = JFT.plan_recovery(object(), n, **kw, **hooks("ref"))
    assert a.to_dict() == b.to_dict()
    assert a.n_devices == b.n_devices and calls["port"] == calls["ref"]
    for s in ("dp", "fsdp", "tp", "fsdp_tp"):
        for m in (1, 2, 4, 8):
            assert FT._model_axis_bounds(s, m) == JFT._model_axis_bounds(s, m)


@pytest.mark.parametrize("case", ["hook", "boundary", "raising", "median"])
def test_straggler_detector_matches_reference(case):
    def boom():
        raise RuntimeError("model not fitted")
    hook = {"hook": lambda: 0.1, "boundary": lambda: 0.1, "raising": boom,
            "median": None}[case]
    times = {"hook": [0.15, 0.25, 0.1], "boundary": [0.2],
             "raising": slow_rank_times(0.1, 8, slow_at=[7], factor=5.0),
             "median": slow_rank_times(0.1, 40, slow_at=[12, 30, 31], factor=3.0)}[case]
    got = []
    for mod in (FT, JFT):
        det = mod.StragglerDetector(tolerance=2.0, window=8, predict_s=hook)
        got.append(([det.observe(i, t) for i, t in enumerate(times)], det.flags,
                    det.expected()))
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# supervisor (tests/test_supervisor.py's contract)
# ---------------------------------------------------------------------------

def _supervisor(policy=None, **kw):
    rec = FakeRecorder()
    return Supervisor(policy=policy or RetryPolicy(), recorder=rec, metrics=Metrics(),
                      sleep=lambda s: None, **kw), rec


def test_classify_and_backoff():
    from repro.train.supervisor import RetryPolicy as JPolicy, classify as jclassify
    for exc in (OSError("x"), TimeoutError("x"), ConnectionError("x"),
                BlockingIOError("x"), ValueError("x"), TypeError("x"), KeyError("x"),
                AssertionError("x"), KeyboardInterrupt(), SystemExit(1)):
        assert classify(exc) == jclassify(exc)
    pol, jpol = (P(backoff_s=0.1, multiplier=2.0, max_backoff_s=0.5)
                 for P in (RetryPolicy, JPolicy))
    assert [pol.backoff_for(i) for i in range(1, 10)] == \
        [jpol.backoff_for(i) for i in range(1, 10)]
    assert [pow2_floor(n) for n in (1, 2, 3, 4, 5, 7, 8, 9)] == [1, 2, 2, 4, 4, 4, 8, 8]


def test_run_retries_fails_fast_exhausts_and_respects_deadline():
    sup, rec = _supervisor(RetryPolicy(max_attempts=4, backoff_s=0.01))
    sleeps = []
    sup.sleep = sleeps.append
    fn = flaky(2)
    assert sup.run("op", fn) == 3 and fn.calls == 3 and sup.retries == 2
    assert sleeps == pytest.approx([0.01, 0.02])
    assert all(r["will_retry"] for r in rec.named("retry"))
    sup, rec = _supervisor()
    fn = failing(exc_type=ValueError)
    with pytest.raises(ValueError):
        sup.run("op", fn)
    assert fn.calls == 1 and sup.retries == 0 and len(rec.named("fatal")) == 1
    sup, rec = _supervisor(RetryPolicy(max_attempts=3, backoff_s=0.01))
    fn = failing(exc_type=OSError)
    with pytest.raises(RetryError) as ei:
        sup.run("ckpt", fn)
    assert fn.calls == 3 and ei.value.attempts == 3
    assert isinstance(ei.value.__cause__, OSError)
    assert not rec.named("retry")[-1]["will_retry"]
    clock = {"t": 0.0}
    sup, _ = _supervisor(RetryPolicy(max_attempts=100, backoff_s=1.0, deadline_s=2.5))
    sup.clock = lambda: clock["t"]
    sup.sleep = lambda s: clock.__setitem__("t", clock["t"] + s)
    fn = failing(exc_type=OSError)
    with pytest.raises(RetryError, match="deadline"):
        sup.run("op", fn)
    assert fn.calls < 100


@pytest.mark.parametrize("slow_at,want", [(range(30, 40), True), ([10, 20], False)])
def test_straggler_escalation(slow_at, want):
    from repro.obs import Metrics as JMetrics, StragglerMonitor as JMonitor
    from repro.train.supervisor import Supervisor as JSupervisor
    got = []
    for det, mon, met, sup_cls in ((FT.StragglerDetector, StragglerMonitor, Metrics,
                                    Supervisor),
                                   (JFT.StragglerDetector, JMonitor, JMetrics,
                                    JSupervisor)):
        rec = FakeRecorder()
        monitor = mon(det(tolerance=2.0), metrics=met(), recorder=rec)
        sup = sup_cls(recorder=rec, metrics=met(), escalate_after=3, sleep=lambda s: None)
        times = slow_rank_times(0.01, 40, slow_at=slow_at, factor=6.0)
        triggers = [s for s, dt in enumerate(times)
                    if sup.note_straggler(s, monitor.observe(s, dt))]
        got.append((triggers, sup.proactive_checkpoints, rec.events))
    assert got[0] == got[1]
    assert bool(got[0][0]) == want
    if want:
        assert got[0][0][0] >= 32


def test_precompiler_contract():
    pc = SurvivorPrecompiler(recorder=FakeRecorder())
    pc.submit((4,), lambda: ("plan4", ("bundle4",)))
    prog = pc.get(5, block=True, timeout=10.0)
    assert prog is not None and prog.plan == "plan4" and prog.bundle == ("bundle4",)
    assert pc.get(7, block=True, timeout=10.0) is prog and pc.get(2) is None
    rec = FakeRecorder()
    pc = SurvivorPrecompiler(recorder=rec)

    def boom():
        raise RuntimeError("build failed")
    pc.submit((2,), boom)
    pc.submit((4,), lambda: ("plan", ()))
    assert pc.get(4, block=True, timeout=10.0) is not None
    assert pc.get(2, block=True, timeout=10.0) is None
    deadline = time.monotonic() + 5.0
    while not rec.named("precompile_failed"):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    stats = pc.stats()
    assert stats["compiled"] == [[4]] and stats["failed"] == [[2]]
    calls = []
    pc = SurvivorPrecompiler()

    def build():
        calls.append(1)
        return ("p", ())
    pc.submit((4,), build)
    assert pc.get(4, block=True, timeout=10.0) is not None
    pc.submit((4,), build)
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# launch.train on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pool():
    with Pool(world=8, device="cpu") as p:
        yield p


def test_train_drill_fsdp8_to_tp4(pool, tmp_path, capsys):
    from repro.obs import read_jsonl as jread_jsonl
    from repro_torch.launch import train
    from repro_torch.train.checkpoint import CheckpointManager
    argv = BASE + ["--device", "cpu", "--devices", "8", "--strategy", "fsdp"]
    ref = train.main(argv, pool=pool)
    drill = train.main(argv + [
        "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "2",
        "--simulate-failure", "4", "--recover-strategy", "tp",
        "--inject-ckpt-fault", "2", "--precompile-survivors", "1",
        "--precompile-block", "--trace-dir", str(tmp_path / "trace")], pool=pool)
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == drill
    rec = drill["recovery"]
    assert rec["at_step"] == 4 and rec["lost_devices"] == 4
    assert rec["before"] == {"mesh": [2, 4], "strategy": "fsdp", "devices": 8}
    assert rec["after"]["strategy"] == drill["strategy"] == "tp"
    assert rec["after"]["devices"] == 4 and rec["restored_step"] == 4
    assert rec["precompiled"] and rec["restore_mode"] == "shard-to-shard"
    assert rec["recovery_s"] > 0 and rec["restore_s"] > 0
    assert set(rec) == {"at_step", "lost_devices", "before", "after", "reason",
                        "restored_step", "steps_replayed", "reinit_leaves",
                        "precompiled", "restore_mode", "plan_s", "compile_s",
                        "restore_s", "first_step_s", "recovery_s"}
    sup = drill["supervisor"]
    assert sup["retries"] == 2 and sup["precompile"]["compiled"] == [[4]]
    assert len(drill["losses"]) == len(ref["losses"]) == 6
    assert max(abs(a - b) for a, b in zip(drill["losses"], ref["losses"])) <= TOL
    cm = CheckpointManager(str(tmp_path / "ckpt"))
    assert cm.available_steps() == [2, 4, 6] and all(cm.verify(s)
                                                       for s in cm.available_steps())
    trace = jread_jsonl(tmp_path / "trace" / "trace.jsonl")
    assert len(trace.find("step")) == 6
    assert {s.name for s in trace.spans} >= {"recovery/compile", "recovery/plan",
                                             "recovery/restore", "data", "dispatch",
                                             "wait"}
    assert drill["metrics"]["recoveries"]["value"] == 1
    assert drill["metrics"]["step_time_ms"]["count"] == 6
    doc = json.load(open(tmp_path / "trace" / "trace_chrome.json"))
    assert sorted({e["pid"] for e in doc["traceEvents"]}) == list(range(8))
    assert trace.meta["chrome_pid"] == "rank" and trace.meta["ranks"] == 8


def test_train_die_and_resume_bit_for_bit(tmp_path, capsys):
    from repro_torch.launch import train
    argv = BASE + ["--device", "cpu", "--batch", "4", "--seq", "16"]
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *argv, *ckpt,
                        "--die-at-step", "3"], capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": SRC}, timeout=300)
    assert r.returncode == 42, r.stderr[-2000:]
    assert "fault injection: dying at step 3" in r.stdout
    ref = train.main(argv)
    resumed = train.main(argv + ckpt)
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed["losses"] == ref["losses"][2:]


def test_train_dry_run_recovery_plan_matches_reference(capsys):
    from repro_torch.launch import train
    r = subprocess.run([sys.executable, "-m", "repro.launch.train", *BASE,
                        "--simulate-failure", "2", "--dry-run"], capture_output=True,
                       text=True, env={**os.environ, "PYTHONPATH": SRC,
                                       "JAX_PLATFORMS": "cpu"}, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])["recovery"]
    got = train.main(BASE + ["--device", "cpu", "--devices", "8", "--simulate-failure",
                             "2", "--dry-run"])["recovery"]
    assert got["devices"] == int(np.prod(got["mesh"])) == 4 and "planner" in got

    def close(a, b):
        if isinstance(a, dict):
            return set(a) == set(b) and all(close(a[k], b[k]) for k in a)
        if isinstance(a, list):
            return len(a) == len(b) and all(close(x, y) for x, y in zip(a, b))
        if isinstance(a, float):
            return math.isclose(a, b, rel_tol=4 * 2.0 ** -23, abs_tol=1e-9)
        return a == b
    assert close(got, want), (got, want)


def test_train_simulate_failure_requires_ckpt_dir():
    from repro_torch.launch import train
    with pytest.raises(SystemExit, match="requires --ckpt-dir"):
        train.main(BASE + ["--device", "cpu", "--simulate-failure", "2"])


def test_elastic_quick(pool, tmp_path, capsys):
    """``launch.elastic --quick``: the reference's tiny drill, cold and
    prebuilt, each at parity with its uninterrupted run, and the measured
    restart costs ranked by the planner's elastic objective."""
    from repro_torch.launch import elastic
    out = tmp_path / "ELASTIC.md"
    rows = elastic.main(["--quick", "--device", "cpu", "--out", str(out)], pool=pool)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["ok"] and summary["drills"] == 2
    (r,) = rows
    assert r["strategy"] == "fsdp" and r["cold"]["parity"] and r["warm"]["parity"]
    assert not r["cold"]["precompiled"] and r["warm"]["precompiled"]
    assert r["cold"]["mesh_before"] == [2, 4]
    assert r["warm"]["restore_mode"] == "shard-to-shard"
    assert set(summary["costs_cold"]) == {"plan_ms", "compile_ms", "restore_ms",
                                          "replay_steps"}
    assert "## Elastic-aware planning" in out.read_text()
