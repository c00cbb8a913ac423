"""Observability (``repro.obs``): span tracing, metrics, export and per-term
attribution, with the reference's ``__all__``.

    from repro_torch.obs import Recorder, current_recorder, use_recorder
    from repro_torch.obs import Metrics, StragglerMonitor
    from repro_torch.obs import write_jsonl, chrome_trace
    from repro_torch.obs import attribution_table, detect_drift
"""
from repro_torch.obs.attribution import (DriftReport, TermRow, attribution_table,
                                         detect_drift, measure_collective_terms,
                                         predicted_step_ms, predicted_terms,
                                         render_markdown, span_coverage)
from repro_torch.obs.export import (TraceData, chrome_trace, read_jsonl,
                                    trace_lines, write_chrome_trace, write_jsonl)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Metrics,
                                     StragglerMonitor, collective_bytes,
                                     device_memory_watermarks, observe_step,
                                     record_collective_bytes,
                                     record_memory_watermarks, record_recovery,
                                     straggler_skew)
from repro_torch.obs.trace import (NULL_SPAN, Recorder, Span, current_recorder,
                                   set_recorder, use_recorder)

__all__ = [
    "Recorder", "Span", "NULL_SPAN", "current_recorder", "set_recorder",
    "use_recorder",
    "Metrics", "Counter", "Gauge", "Histogram", "StragglerMonitor",
    "observe_step", "collective_bytes", "record_collective_bytes",
    "device_memory_watermarks", "record_memory_watermarks",
    "record_recovery", "straggler_skew",
    "TraceData", "trace_lines", "write_jsonl", "read_jsonl",
    "chrome_trace", "write_chrome_trace",
    "TermRow", "DriftReport", "predicted_terms", "predicted_step_ms",
    "measure_collective_terms", "attribution_table", "render_markdown",
    "span_coverage", "detect_drift",
]
