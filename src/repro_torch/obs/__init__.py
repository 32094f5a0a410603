"""Observability layer: frame-lifecycle tracing + unified metrics registry.

Three pieces, the port's copies of the reference's `obs` package:

  * `obs.trace` — `Tracer`/`NULL_TRACER`, span taxonomy for the seven
    frame-lifecycle stages and the QoS/ARQ/admission/slot instant events;
  * `obs.registry` — `MetricsRegistry` of labeled counters/gauges/
    P²-backed histograms with text/dict export;
  * `obs.export` — Chrome-trace-event JSON (Perfetto-loadable) writer and
    the schema/nesting validators CI runs.
"""
from repro_torch.obs.registry import (Counter, DEFAULT_REGISTRY, Gauge,
                                      Histogram, MetricsRegistry)
from repro_torch.obs.trace import (
    EVT_ADMISSION_REJECT, EVT_ARQ_RECONNECT, EVT_ARQ_RETRANSMIT,
    EVT_QOS_TRANSITION, EVT_SLOT_ADMIT, EVT_SLOT_EVICT, INSTANT_EVENTS,
    LIFECYCLE_SPANS, NULL_TRACER, NullTracer, SERVE_TID, SPAN_ARQ_ACCEPT,
    SPAN_CLIENT_ENCODE, SPAN_DECODE, SPAN_QUEUE_WAIT, SPAN_REPLY, SPAN_STEP,
    SPAN_WIRE_SEND, Tracer, session_tid)
from repro_torch.obs.export import (chrome_trace, check_span_nesting,
                                    dump_json, validate_chrome_trace,
                                    write_trace)

__all__ = [
    "Counter", "DEFAULT_REGISTRY", "Gauge", "Histogram", "MetricsRegistry",
    "EVT_ADMISSION_REJECT", "EVT_ARQ_RECONNECT", "EVT_ARQ_RETRANSMIT",
    "EVT_QOS_TRANSITION", "EVT_SLOT_ADMIT", "EVT_SLOT_EVICT",
    "INSTANT_EVENTS", "LIFECYCLE_SPANS", "NULL_TRACER", "NullTracer",
    "SERVE_TID", "SPAN_ARQ_ACCEPT", "SPAN_CLIENT_ENCODE", "SPAN_DECODE",
    "SPAN_QUEUE_WAIT", "SPAN_REPLY", "SPAN_STEP", "SPAN_WIRE_SEND",
    "Tracer", "session_tid", "chrome_trace", "check_span_nesting",
    "dump_json", "validate_chrome_trace", "write_trace",
]
