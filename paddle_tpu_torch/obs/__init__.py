"""paddle_tpu_torch.obs — serving observability, the port of
``paddle_tpu/obs``: where a request spent its time, TTFT/TPOT at p50/p99,
what the engine's step timeline looked like, where each step's wall time
went, and what the engine was doing right before it died.

- :mod:`.trace` — per-request lifecycle traces (:class:`Tracer`,
  :class:`RequestTrace`): timestamped events from the engine clock,
  summarized into queue_wait / prefill_time / TTFT / TPOT / e2e.
- :mod:`.histogram` — fixed-bucket streaming :class:`Histogram` and the
  label-keyed :class:`HistogramFamily` behind the ``serving_*_s``
  percentile gauges.
- :mod:`.timeline` — the engine loop's bounded per-step ring
  (:class:`StepTimeline`).
- :mod:`.attribution` — :class:`PhaseAccumulator` (exact per-phase step
  wall-time split) and :class:`RooflineTracker` (measured step time
  against predicted roofline time).
- :mod:`.alerts` — edge-triggered anomaly watchdogs (:class:`Watchdog`).
- :mod:`.journey` — request journeys (:class:`Journey`,
  :class:`JourneyBook`), exportable as the ``paddle-tpu/journey/v1`` wire
  dict (:func:`validate_journey`).
- :mod:`.tenant` — per-tenant SLO classes (:class:`TenantSLO`) and the
  goodput/badput ledger (:class:`TenantLedger`).
- :mod:`.recorder` — the flight recorder: schema-versioned JSON dumps (v2;
  v1 dumps stay readable).
- :mod:`.export` — Chrome ``trace_event`` JSON and Prometheus text.

Metric names, label sets, the Chrome trace layout and both schemas are
the reference's, so a dump written by either package validates under the
other's ``validate_*``. :mod:`.fleetscope` is the cluster grain: exchange
spans, the merged ``replica=`` scrape and the fleet record.

``python -m paddle_tpu_torch.obs --flight-record DUMP`` pretty-prints a
flight record; exit 0 clean, 1 alerts/fatal recorded, 2 bad usage.

Imports nothing from ``paddle_tpu_torch.serving`` — serving imports us.
Pure host Python: no torch, no device reads.
"""
from .alerts import RULES as ALERT_RULES  # noqa: F401
from .alerts import Alert, Watchdog, WatchdogConfig  # noqa: F401
from .attribution import (DEFAULT_PEAK_FLOPS_PER_S,  # noqa: F401
                          DEFAULT_PEAK_HBM_BYTES_PER_S, PHASES,
                          PhaseAccumulator, RooflineTracker)
from .export import (chrome_trace, latency_table,  # noqa: F401
                     prometheus_text, write_chrome_trace)
from .histogram import (LATENCY_EDGES_S, OCCUPANCY_EDGES,  # noqa: F401
                        QUANTILES, Histogram, HistogramFamily,
                        split_labels)
from .journey import (JOURNEY_SCHEMA, Journey, JourneyBook,  # noqa: F401
                      format_journey, validate_journey)
from .recorder import (FLIGHT_RECORD_SCHEMA,  # noqa: F401
                       FLIGHT_RECORD_SCHEMA_V1, build_flight_record,
                       dump_flight_record, format_flight_record,
                       validate_flight_record)
from .tenant import TENANT_CLASSES  # noqa: F401
from .tenant import (TenantLedger, TenantSLO,  # noqa: F401
                     check_tenant_name, tenant_table)
from .timeline import StepRecord, StepTimeline  # noqa: F401
from .trace import RequestTrace, TraceEvent, Tracer  # noqa: F401

__all__ = ["Histogram", "HistogramFamily", "LATENCY_EDGES_S",
           "OCCUPANCY_EDGES", "QUANTILES", "split_labels",
           "Tracer", "RequestTrace", "TraceEvent",
           "StepTimeline", "StepRecord",
           "PHASES", "PhaseAccumulator", "RooflineTracker",
           "DEFAULT_PEAK_FLOPS_PER_S", "DEFAULT_PEAK_HBM_BYTES_PER_S",
           "Alert", "ALERT_RULES", "Watchdog", "WatchdogConfig",
           "JOURNEY_SCHEMA", "Journey", "JourneyBook",
           "validate_journey", "format_journey",
           "TENANT_CLASSES", "TenantSLO", "TenantLedger",
           "check_tenant_name", "tenant_table",
           "FLIGHT_RECORD_SCHEMA", "FLIGHT_RECORD_SCHEMA_V1",
           "build_flight_record", "dump_flight_record",
           "format_flight_record", "validate_flight_record",
           "chrome_trace", "write_chrome_trace", "prometheus_text",
           "latency_table"]
