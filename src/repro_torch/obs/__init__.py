"""repro.obs — observability.

Request-lifecycle tracing on the simulation clock and wall-clock spans
of the host (``trace``), a counter/gauge/histogram
registry (``metrics``), Chrome trace-event / Perfetto export
(``export``), and per-request SLO-violation attribution (``slo``).
See DESIGN.md section 16 for the determinism and fastpath-equivalence
contracts.
"""
from .trace import (CONTROLLER_TRACK, GOVERNOR_TRACK, INSTANT,
                    LIFECYCLE_TRACK, NULL_TRACER, SPAN, TIER_TRACK,
                    TraceEvent, Tracer, WallSpan, self_times,
                    controller_action_from_event,
                    event_from_controller_action,
                    event_from_governor_decision,
                    governor_decision_from_event)
from .metrics import (LATENCY_BOUNDS_S, Counter, Gauge, Histogram,
                      MetricsRegistry, collect_run_metrics)
from .export import (assert_complete_lifecycles, chrome_trace,
                     request_lifecycles, text_summary,
                     validate_chrome_trace)
from .slo import (Attribution, attribute_run, attribute_tpot,
                  attribute_ttft, blame_table, transfer_queue_share)

__all__ = [
    "TraceEvent", "Tracer", "NULL_TRACER", "SPAN", "INSTANT", "WallSpan",
    "self_times",
    "LIFECYCLE_TRACK", "GOVERNOR_TRACK", "CONTROLLER_TRACK", "TIER_TRACK",
    "event_from_governor_decision", "governor_decision_from_event",
    "event_from_controller_action", "controller_action_from_event",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "LATENCY_BOUNDS_S", "collect_run_metrics",
    "chrome_trace", "validate_chrome_trace", "request_lifecycles",
    "assert_complete_lifecycles", "text_summary",
    "Attribution", "attribute_ttft", "attribute_tpot", "attribute_run",
    "blame_table", "transfer_queue_share",
]
