"""Flight-recorder telemetry: streaming per-step JSONL and heartbeat markers.

Port of ``distributed_llm_training_benchmark_framework_tpu/telemetry``. The
result markers (``utils.metrics``) speak only after a successful run; a run
that hangs, runs out of memory or is preempted part way leaves nothing for
``scripts/collect_results.sh`` to scrape. This is the in-flight channel:

- :class:`TelemetryRecorder` streams JSONL events (``run_meta``,
  ``phase_begin`` / ``phase_end``, ``step_window``, ``anomaly``,
  ``run_aborted``, ``run_end``) to ``<results_dir>/telemetry_<arm>.jsonl``,
  line-buffered, so a killed process keeps every event up to its last
  sync boundary;
- single-line ``BENCHMARK_HEARTBEAT {json}`` markers on stdout (rank 0, at
  sync boundaries only) make partial progress recoverable from logs alone;
- an excepthook / atexit flusher records a final ``run_aborted`` event on
  any crash the process survives long enough to report.
"""

from .recorder import (  # noqa: F401
    HEARTBEAT_MARKER,
    PHASES,
    SCHEMA_VERSION,
    TelemetryRecorder,
    is_rank_sibling,
    parse_heartbeat_line,
    rank_telemetry_files,
    read_events,
    spike_mask_intervals,
    step_in_spike,
    telemetry_filename,
)
