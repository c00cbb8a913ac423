"""Port parity: observability (``repro_torch.obs``: trace, metrics, export,
attribution) against the reference's ``repro.obs``.

With a fake clock the same span sequence gives the same ``trace_lines`` and
Chrome trace in both packages, and a ``trace.jsonl`` written by either
reads through the other's ``read_jsonl``; ``collective_bytes`` equals the
reference's for every strategy of the registry on meshes (8,), (4, 2) and
(2, 4); ``predicted_terms`` / ``predicted_step_ms`` agree to four float32
ulps under the checked-in calibration; ``attribution_table``,
``render_markdown``, ``span_coverage`` and ``detect_drift`` give the same
output on the same rows; a disabled recorder records nothing. The measured
side (``measure_collective_terms`` and ``launch.trace_report --quick``) and
``launch.serve --trace-dir`` run on the CPU: a ``Pool`` of 4 for the module.
"""
import json

import numpy as np
import pytest

import repro.obs as J
from repro.perf.costmodel import (Calibration as JCalibration,
                                  LinkParams as JLinkParams,
                                  ScheduleInputs as JScheduleInputs,
                                  load_calibration as jload_calibration)
from repro_torch import obs as O
from repro_torch.dist.pool import Pool
from repro_torch.dist.sharding import STRATEGIES
from repro_torch.perf.costmodel import (Calibration, LinkParams, ScheduleInputs,
                                        load_calibration)


class FakeClock:
    def __init__(self, tick=0.001):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t


def _record(pkg):
    rec = pkg.Recorder(clock=FakeClock())
    for i in range(2):
        with rec.span("step", category="train", step_num=i, phase="steady") as sp:
            with rec.span("data", category="train"):
                pass
            with rec.span("dispatch", category="train"):
                rec.event("straggler", step=i, skew=2.0)
            with rec.span("wait", category="train"):
                pass
            sp.set(ms=1.5)
    with pytest.raises(ValueError):
        with rec.span("recovery/restore", category="recovery", step_num=2):
            raise ValueError("boom")
    return rec


def test_trace_lines_and_chrome_trace_match_reference(tmp_path):
    rec, jrec = _record(O), _record(J)
    m = O.Metrics()
    O.observe_step(m, seconds=0.5, batch=8, seq=32)
    jm = J.Metrics()
    J.observe_step(jm, seconds=0.5, batch=8, seq=32)
    assert m.to_dict() == jm.to_dict()
    meta = {"arch": "smollm-360m", "ranks": 1}
    assert O.trace_lines(rec, metrics=m.to_dict(), meta=meta) == \
        J.trace_lines(jrec, metrics=jm.to_dict(), meta=meta)
    assert O.chrome_trace(rec) == J.chrome_trace(jrec)
    # each package reads the other's file
    O.write_jsonl(tmp_path / "port.jsonl", rec, metrics=m.to_dict(), meta=meta)
    J.write_jsonl(tmp_path / "ref.jsonl", jrec, metrics=jm.to_dict(), meta=meta)
    for a, b in ((J.read_jsonl(tmp_path / "port.jsonl"), O.read_jsonl(tmp_path / "ref.jsonl")),):
        assert [s.to_dict() for s in a.spans] == [s.to_dict() for s in b.spans]
        assert a.events == b.events and a.metrics == b.metrics and a.meta == b.meta
    assert len(O.read_jsonl(tmp_path / "port.jsonl").spans) == len(rec.spans) == 9


def test_chrome_trace_ranks_one_pid_a_rank():
    from repro_torch.obs.export import chrome_trace_ranks, recorded
    recs = {r: recorded(_record(O)) for r in range(3)}
    doc = chrome_trace_ranks(recs)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert sorted({e["pid"] for e in xs}) == [0, 1, 2]
    assert len(xs) == 3 * 9
    names = {e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert names == {"rank 0", "rank 1", "rank 2"}


def test_disabled_recorder_records_nothing():
    rec = O.Recorder(enabled=False)
    with rec.span("step", step_num=3) as sp:
        sp.set(ms=1.0)
        assert sp.sync(42) == 42
    rec.event("straggler", step=3)
    assert rec.spans == [] and rec.events == [] and rec.open_spans == 0
    assert O.current_recorder().enabled is False
    assert O.device_memory_watermarks() == {}           # no CUDA device here


def test_metrics_and_straggler_monitor_match_reference():
    from repro.train.ft import StragglerDetector as JDet
    from repro_torch.train.ft import StragglerDetector
    got = []
    for pkg, det in ((O, StragglerDetector), (J, JDet)):
        rec, m = pkg.Recorder(clock=FakeClock()), pkg.Metrics()
        mon = pkg.StragglerMonitor(det(tolerance=1.5), metrics=m, recorder=rec)
        flags = [mon.observe(s, t) for s, t in enumerate([0.1] * 8 + [0.9, 0.1])]
        h = m.histogram("ms")
        for v in (1.0, 2.0, 3.0, 10.0):
            h.observe(v)
        pkg.record_recovery(m, {"plan_s": 0.1, "restore_s": 0.2, "steps_replayed": 1})
        got.append((flags, m.to_dict(), rec.events, mon.flags))
    assert got[0] == got[1]
    assert got[0][0][8] and got[0][3] == [8]
    assert O.straggler_skew([0.1, 0.1, 0.1, 0.3]) == J.straggler_skew([0.1, 0.1, 0.1, 0.3])
    with pytest.raises(TypeError):
        m = O.Metrics()
        m.counter("steps")
        m.gauge("steps")


MESHES = [{"data": 8}, {"data": 4, "model": 2}, {"data": 2, "model": 4}]


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_collective_bytes_match_reference(strategy):
    for axes in MESHES:
        for kw in ({}, {"wire_bits": 8, "act_bytes": 4096}):
            assert O.collective_bytes(strategy, 8, 123456, axes=axes, **kw) == \
                J.collective_bytes(strategy, 8, 123456, axes=axes, **kw)
        m, jm = O.Metrics(), J.Metrics()
        O.record_collective_bytes(m, strategy, 8, 1000, axes=axes)
        J.record_collective_bytes(jm, strategy, 8, 1000, axes=axes)
        assert m.to_dict() == jm.to_dict()


def _ulps(a, b):
    return abs(a - b) / float(np.spacing(np.float32(max(abs(a), abs(b), 1e-30))))


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_predicted_terms_and_step_match_reference(strategy):
    cal, jcal = load_calibration(), jload_calibration()
    for axes in MESHES:
        inp = ScheduleInputs(n_devices=8, param_bytes=1 << 22, wire_bits=8, act_bytes=1 << 16)
        jinp = JScheduleInputs(n_devices=8, param_bytes=1 << 22, wire_bits=8,
                               act_bytes=1 << 16)
        got = O.predicted_terms(strategy, inp, calibration=cal, axes=axes)
        want = J.predicted_terms(strategy, jinp, calibration=jcal, axes=axes)
        assert set(got) == set(want)
        for k in got:
            assert {f: v for f, v in got[k].items() if f != "ms"} == \
                {f: v for f, v in want[k].items() if f != "ms"}
            assert _ulps(got[k]["ms"], want[k]["ms"]) <= 4
        a = O.predicted_step_ms(strategy, inp, compute_ms=7.5, calibration=cal, axes=axes)
        b = J.predicted_step_ms(strategy, jinp, compute_ms=7.5, calibration=jcal, axes=axes)
        assert set(a) == set(b)
        for k in a:
            assert _ulps(a[k], b[k]) <= 4, k


def _rows_pair():
    pred = {"all_reduce/data/grad": {"op": "all_reduce", "axis": "data", "tensor": "grad",
                                     "ring": 8, "bytes": 100.0, "count": 1, "ms": 2.0},
            "all_gather/data/param": {"op": "all_gather", "axis": "data",
                                      "tensor": "param", "ring": 8, "bytes": 50.0,
                                      "count": 2, "ms": 1.0}}
    meas = {"all_reduce/data/grad": {**pred["all_reduce/data/grad"], "ms": 1.5},
            "all_to_all/data/act": {"op": "all_to_all", "axis": "data", "tensor": "act",
                                    "ring": 8, "bytes": 10.0, "count": 1, "ms": 0.5}}
    return (O.attribution_table(pred, meas, measured_compute_ms=4.0),
            J.attribution_table(pred, meas, measured_compute_ms=4.0))


def test_attribution_table_markdown_coverage_drift_match_reference():
    rows, jrows = _rows_pair()
    assert [r.to_dict() for r in rows] == [r.to_dict() for r in jrows]
    assert O.render_markdown(rows, title="t") == J.render_markdown(jrows, title="t")
    rec, jrec = _record(O), _record(J)
    assert O.span_coverage(rec.spans, "step") == J.span_coverage(jrec.spans, "step")
    assert O.span_coverage(rec.spans, "absent") == J.span_coverage(jrec.spans, "absent")
    link, jlink = LinkParams(alpha_s=1e-5, bw_bytes_per_s=1e9), JLinkParams(
        alpha_s=1e-5, bw_bytes_per_s=1e9)
    spec = [("compute", 10.0, 10.1), ("all_reduce/data/grad", 10.0, 11.0),
            ("all_gather/data/param", 1.0, 3.5), ("reduce_scatter/data/grad", 0.001, 0.9),
            ("all_to_all/data/act", 100.0, 103.0), ("unmeasured/x/y", 5.0, None)]
    for mae in (1.0, None):
        meta = {} if mae is None else {"mae_ms_fitted": mae}
        cal = Calibration(label="test", default=link, meta=meta)
        jcal = JCalibration(label="test", default=jlink, meta=meta)
        a = O.detect_drift([O.TermRow(*s) for s in spec], cal)
        b = J.detect_drift([J.TermRow(*s) for s in spec], jcal)
        assert a.to_dict()["flagged"] == b.to_dict()["flagged"]
        assert a.band_ms == b.band_ms and a.refit_recommended == b.refit_recommended
    assert set(O.__all__) == set(J.__all__)


# ---------------------------------------------------------------------------
# The measured side and the traced entry points, on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pool():
    with Pool(world=4, device="cpu") as p:
        yield p


def test_measure_collective_terms_keys_and_times(pool):
    inp = ScheduleInputs(n_devices=4, param_bytes=1 << 16, act_bytes=1 << 12)
    for strategy, axes in (("fsdp_tp", {"data": 2, "model": 2}), ("dp", {"data": 4})):
        pred = O.predicted_terms(strategy, inp, axes=axes)
        meas = O.measure_collective_terms(pool, strategy, inp, axes=axes, iters=2, warmup=1)
        assert set(meas) == set(pred)
        for k, m in meas.items():
            assert m["ms"] > 0 and m["count"] == pred[k]["count"]
            assert m["bytes"] == pred[k]["bytes"]


def test_trace_report_quick(pool, tmp_path, capsys):
    from repro_torch.launch import trace_report
    out = tmp_path / "TRACE.md"
    points = trace_report.main(["--quick", "--strategies", "fsdp", "--device", "cpu",
                                "--out", str(out)], pool=pool)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["ok"] and summary["strategies"] == ["fsdp"]
    (p,) = points
    assert p["mesh"] == {"data": 4} and p["steps"] == 3
    assert all(abs(1 - c) <= trace_report.COVERAGE_TOL for c in p["step_coverage"])
    assert [r.term for r in p["rows"]][0] == "compute"
    assert all(r.measured_ms is not None and r.measured_ms > 0 for r in p["rows"])
    assert p["overhead"]["rounds"] == 2
    assert "## fsdp" in out.read_text()


def test_serve_trace_dir(tmp_path):
    from repro_torch.launch import serve
    served = serve.main(["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
                         "5", "--gen", "4", "--trace-dir", str(tmp_path)])
    assert served.report["trace"] == {"dir": str(tmp_path), "spans": 6}
    data = J.read_jsonl(tmp_path / "trace.jsonl")
    assert [len(data.find(n)) for n in ("prefill", "decode", "decode_step")] == [1, 1, 4]
    decode = data.find("decode")[0]
    assert {s.parent_id for s in data.find("decode_step")} == {decode.span_id}
    assert data.metrics["decode_dispatch_ms"]["count"] == 4
    assert data.meta["mode"] == "serve"
    doc = json.load(open(tmp_path / "trace_chrome.json"))
    assert sum(e["ph"] == "X" for e in doc["traceEvents"]) == 6
