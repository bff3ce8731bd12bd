"""The flight recorder: crash-resilient JSONL events and stdout heartbeats.

Port of ``distributed_llm_training_benchmark_framework_tpu/telemetry/recorder.py``,
with its event schema, keys and file names unchanged, so the JAX package's
``analysis/telemetry_report.py`` and ``analysis/validate_results.py`` read
the port's files as they read JAX's.

- **Crash resilience over buffering.** The JSONL file is line-buffered
  (``buffering=1``): every event reaches the OS when its line completes, so
  a SIGKILLed process keeps everything up to its last sync boundary.
- **No device syncs.** The recorder is host bookkeeping, called at
  sync-window boundaries where the loop has already fenced the device. Its
  one device-adjacent read, the allocator's high-water mark
  (``utils.metrics.peak_hbm_bytes``: ``torch.cuda.max_memory_allocated``),
  is a host-side query.
- **Best effort.** A full disk or a removed results directory degrades the
  telemetry and never fails the benchmark: every write swallows ``OSError``.

``ts`` is unix wall time; ``rel`` is seconds since the recorder was made,
on the monotonic clock.
"""

from __future__ import annotations

import atexit
import json
import math
import os
import re
import sys
import time
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 1

#: The stdout scrape marker: ``scripts/collect_results.sh`` greps this
#: literal, so partial progress survives in pod logs when the final
#: BENCHMARK_RESULT_JSON markers never print.
HEARTBEAT_MARKER = "BENCHMARK_HEARTBEAT"

#: Canonical phase names, in their natural run order. ``begin_phase``
#: accepts only these — a typo'd phase would silently fork the attribution.
PHASES = (
    "init", "compile", "warmup", "timed", "trace", "checkpoint", "finalize",
)

#: A window whose mean step time exceeds SPIKE_FACTOR x the median of the
#: preceding windows opens a ``step_time_spike`` anomaly; a later window
#: back under SPIKE_RESOLVE_FACTOR x median resolves it. A spike that
#: persists for SPIKE_REBASELINE_WINDOWS consecutive windows is a
#: sustained slowdown, not a stall: it resolves as "rebaselined" and its
#: level becomes the new median — otherwise the frozen history could
#: never catch up and a successfully completed (if slower) run would be
#: rejected by the validator as an open anomaly. NaN losses are never
#: resolved.
SPIKE_FACTOR = 3.0
SPIKE_RESOLVE_FACTOR = 1.5
SPIKE_MIN_HISTORY = 3
SPIKE_REBASELINE_WINDOWS = 5


def telemetry_filename(arm: str, rank: int = 0) -> str:
    """Rank 0 owns the canonical ``telemetry_<arm>.jsonl`` (paired with the
    result row by slug); every other rank of a multi-host run streams its
    own ``telemetry_<arm>.rank<r>.jsonl`` beside it — a straggling or
    preempted non-zero rank is then visible directly instead of only
    through rank 0's window times (telemetry follow-up (a))."""
    if rank and rank > 0:
        return f"telemetry_{arm}.rank{rank}.jsonl"
    return f"telemetry_{arm}.jsonl"


#: The rank-sibling suffix contract, in one place: telemetry_filename
#: builds it, rank_telemetry_files and is_rank_sibling match it.
_RANK_SIBLING_RE = re.compile(r"\.rank(\d+)\.jsonl$")


def is_rank_sibling(path: str) -> bool:
    """True for a non-zero rank's ``telemetry_<arm>.rank<r>.jsonl`` file
    (which reports under its rank-0 file, never as a standalone run)."""
    return _RANK_SIBLING_RE.search(os.path.basename(path)) is not None


def rank_telemetry_files(path: str) -> Dict[int, str]:
    """{rank: path} for a rank-0 telemetry file and its rank siblings.

    ``path`` is the canonical ``telemetry_<arm>.jsonl``; the rank files
    live beside it. Used by analysis.telemetry_report to merge a
    multi-host run's per-rank streams into one straggler view.
    """
    import glob as _glob

    out: Dict[int, str] = {0: path}
    base = os.path.basename(path)
    if not (base.startswith("telemetry_") and base.endswith(".jsonl")):
        return out
    stem = base[:-len(".jsonl")]
    pattern = os.path.join(
        os.path.dirname(path) or ".", f"{stem}.rank*.jsonl"
    )
    for sibling in sorted(_glob.glob(pattern)):
        m = _RANK_SIBLING_RE.search(sibling)
        if m:
            out[int(m.group(1))] = sibling
    return out


def spike_mask_intervals(
    events: List[Dict[str, Any]],
) -> List[tuple]:
    """Step intervals during which a ``step_time_spike`` anomaly was open.

    Returns ``[(open_step, resolve_step | None), ...]`` — a window whose
    step satisfies ``open_step <= step < resolve_step`` ran while the
    recorder's spike screen was tripped (the resolving window itself
    measured back under the threshold and stays unmasked — EXCEPT for a
    ``rebaselined`` resolution, where the resolving window was still at
    the elevated level so the interval extends one step past it; ``None``
    means the spike never resolved, masking to the end of the run). The
    shared source of truth for window-level anomaly masking:
    ``regress.stats`` excludes these windows from comparison samples, and
    the masking is surfaced as a ``masked_windows`` count so it is never
    silent.
    """
    out: List[tuple] = []
    open_step: Optional[int] = None
    for e in events:
        if (
            e.get("event") == "anomaly"
            and e.get("kind") == "step_time_spike"
            and open_step is None
        ):
            open_step = e.get("step")
        elif (
            e.get("event") == "anomaly_resolved"
            and e.get("kind") == "step_time_spike"
            and open_step is not None
        ):
            hi = e.get("step")
            if e.get("rebaselined") and hi is not None:
                hi = hi + 1
            out.append((open_step, hi))
            open_step = None
    if open_step is not None:
        out.append((open_step, None))
    return out


def step_in_spike(step: Optional[int], intervals: List[tuple]) -> bool:
    """True when ``step`` falls inside any open-spike interval."""
    if step is None:
        return False
    for lo, hi in intervals:
        if lo is not None and step >= lo and (hi is None or step < hi):
            return True
    return False


def parse_heartbeat_line(line: str) -> Optional[Dict[str, Any]]:
    """Decode one ``BENCHMARK_HEARTBEAT {json}`` stdout line (or None).

    The single shared parser: the collect script's grep/sed pipeline and
    the tests both anchor on the same ``MARKER + space + JSON`` shape this
    function accepts.
    """
    line = line.strip()
    if not line.startswith(HEARTBEAT_MARKER + " "):
        return None
    try:
        payload = json.loads(line[len(HEARTBEAT_MARKER) + 1:])
    except json.JSONDecodeError:
        return None
    return payload if isinstance(payload, dict) else None


def read_events(path: str) -> List[Dict[str, Any]]:
    """Load a telemetry JSONL file, tolerating a torn final line.

    A process killed mid-write legitimately leaves a truncated last line;
    every complete line before it is still a valid event. A malformed line
    anywhere *else* raises — that is corruption, not a crash artifact.
    """
    events: List[Dict[str, Any]] = []
    with open(path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break  # torn tail from a mid-write kill
            raise
    return events


class TelemetryRecorder:
    """Streams run telemetry; tracks phase-time attribution for the result.

    Parameters
    ----------
    arm:
        Run slug — the same stem as the result filename, so
        ``result_<arm>.json`` and ``telemetry_<arm>.jsonl`` pair up.
    results_dir:
        Where the JSONL lands; ``None`` (bench.py in-process arms) keeps
        the recorder alive for phase accounting but writes no file.
    is_main:
        Only rank 0 writes the file and prints heartbeats; other ranks
        still track phases so their (unpublished) results stay coherent.
    heartbeat_every_sec:
        Minimum wall seconds between heartbeat lines. ``0`` prints one per
        step window (tests); the first window always prints one so even a
        run killed in its second window left a scrapeable line.
    tokens_per_step:
        Global tokens consumed per optimizer step — turns window step
        times into the cumulative tokens/sec the heartbeat advertises.
    meta:
        Run-identity dict echoed into ``run_meta`` and every heartbeat
        (strategy/world_size/seq_len/tier/... — what collect_results.sh
        needs to synthesize a partial result row).
    """

    def __init__(
        self,
        arm: str,
        *,
        results_dir: Optional[str] = None,
        is_main: bool = True,
        enabled: bool = True,
        heartbeat_every_sec: float = 30.0,
        tokens_per_step: int = 0,
        total_steps: int = 0,
        rank: int = 0,
        meta: Optional[Dict[str, Any]] = None,
    ):
        self.arm = arm
        self.is_main = is_main
        self.enabled = enabled
        self.rank = int(rank)
        self.heartbeat_every_sec = heartbeat_every_sec
        self.tokens_per_step = tokens_per_step
        self.total_steps = total_steps
        self.meta = dict(meta or {})
        self._t0 = time.perf_counter()
        self._phase: Optional[str] = None
        self._phase_t0 = self._t0
        self._phase_times: Dict[str, float] = {}
        self._file = None
        self._closed = False
        self._last_step: Optional[int] = None
        self._last_loss: Optional[float] = None
        self._last_hb_t: Optional[float] = None
        self._cum_tokens = 0
        self._cum_window_sec = 0.0
        self._window_dts: List[float] = []
        self._n_anomalies = 0
        self._nan_anomalies = 0
        self._last_hbm_peak_gib: Optional[float] = None
        # Streaming-data accounting (data/prefetch.py): the wait the loop
        # spent starved for input against the window wall it happened in,
        # and the quarantine ledger's total. Synthetic runs never pass the
        # fields, so their telemetry and heartbeat bytes are unchanged.
        self._has_data_path = False
        self._cum_data_wait_sec = 0.0
        self._cum_data_window_sec = 0.0
        self._records_skipped: Optional[int] = None
        self._open_spike: Optional[int] = None  # step that opened the spike
        self._spike_dts: List[float] = []  # window dts while a spike is open
        self.path: Optional[str] = None
        # Rank 0 writes the canonical file; non-zero ranks of a multi-host
        # run stream their own rank-suffixed sibling (per-rank telemetry —
        # heartbeats stay rank-0-only below, the stdout scrape channel has
        # exactly one writer).
        writes_file = is_main or self.rank > 0
        if enabled and writes_file and results_dir:
            try:
                os.makedirs(results_dir, exist_ok=True)
                self.path = os.path.join(
                    results_dir, telemetry_filename(arm, rank=self.rank)
                )
                # buffering=1: line-buffered — each event line reaches the
                # OS as soon as it is written (the crash-resilience core).
                self._file = open(self.path, "w", buffering=1)
            except OSError as e:
                self._file = None
                print(f"WARNING: telemetry file unavailable: {e}",
                      file=sys.stderr)
        self._emit("run_meta", arm=arm, schema_version=SCHEMA_VERSION,
                   tokens_per_step=tokens_per_step, total_steps=total_steps,
                   **self.meta)
        # Backstop flushers for crash paths the loop's try/except never
        # sees (interpreter teardown, uncaught errors outside the loop).
        # The loop's own abort() remains the primary path and wins the
        # _closed race.
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._excepthook
        atexit.register(self._atexit_flush)

    # ------------------------------------------------------------------
    # Event plumbing
    # ------------------------------------------------------------------

    def _rel(self) -> float:
        return time.perf_counter() - self._t0

    def _emit(self, event: str, **fields: Any) -> None:
        if self._file is None:
            return
        rec = {"event": event, "ts": round(time.time(), 6),
               "rel": round(self._rel(), 6)}
        rec.update(fields)
        try:
            self._file.write(json.dumps(rec) + "\n")
        except (OSError, ValueError):
            pass  # telemetry must never fail the run

    def note(self, event: str, **fields: Any) -> None:
        """Emit one ad-hoc event into the JSONL stream.

        The public hook for loop-adjacent machinery (fault injection,
        checkpoint-save failures) that has something worth recording but
        no schema claim of its own. Same best-effort semantics as every
        other emit: a failed write never fails the run. Callers are
        bound by the same cadence discipline as step_window — sync
        boundaries only.
        """
        self._emit(event, **fields)

    def note_resume(
        self, *, step: int, n_restarts: int, baseline_loss: Optional[float] = None,
        geometry_changed: bool = False,
        source_geometry: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Record that this run restored a checkpoint and continued.

        Emits a ``resume`` event and folds ``resumed``/``n_restarts``
        into the run-identity meta, so every subsequent heartbeat — and
        the final ``run_end``/``run_aborted`` summary — carries the
        stitch. A resumed run must never be mistakable for a clean
        baseline anywhere downstream (regress registry, partial rows).
        ``geometry_changed`` marks an elastic (cross-mesh) resume; the
        source mesh rides the event for the audit trail.
        """
        self.meta["resumed"] = True
        self.meta["n_restarts"] = int(n_restarts)
        if geometry_changed:
            self.meta["resume_geometry_changed"] = True
        self._emit(
            "resume", step=step, n_restarts=int(n_restarts),
            baseline_loss=(
                round(baseline_loss, 6)
                if baseline_loss is not None and math.isfinite(baseline_loss)
                else None
            ),
            geometry_changed=bool(geometry_changed),
            source_geometry=source_geometry,
        )

    # ------------------------------------------------------------------
    # Phases
    # ------------------------------------------------------------------

    @property
    def phase(self) -> Optional[str]:
        return self._phase

    def begin_phase(self, name: str) -> None:
        """End the current phase (if any) and begin ``name``.

        Phases are sequential and non-overlapping by construction, so
        their durations sum to the covered wall time — the property the
        telemetry_report attribution and the validate_results envelope
        both rely on.
        """
        if name not in PHASES:
            raise ValueError(f"unknown telemetry phase {name!r} "
                             f"(expected one of {PHASES})")
        now = time.perf_counter()
        if self._phase is not None:
            dur = now - self._phase_t0
            self._phase_times[self._phase] = (
                self._phase_times.get(self._phase, 0.0) + dur
            )
            self._emit("phase_end", phase=self._phase, dur_sec=round(dur, 6))
        self._phase = name
        self._phase_t0 = now
        self._emit("phase_begin", phase=name)

    def phase_times(self) -> Dict[str, float]:
        """Per-phase accumulated seconds, including the open phase so far."""
        out = dict(self._phase_times)
        if self._phase is not None:
            out[self._phase] = (
                out.get(self._phase, 0.0)
                + (time.perf_counter() - self._phase_t0)
            )
        return out

    def wall_time_total(self) -> float:
        return self._rel()

    @property
    def n_anomalies(self) -> int:
        return self._n_anomalies

    @property
    def n_unresolved_anomalies(self) -> int:
        return self._nan_anomalies + (1 if self._open_spike is not None else 0)

    # ------------------------------------------------------------------
    # Step windows (called at sync boundaries only)
    # ------------------------------------------------------------------

    @property
    def data_stall_frac(self) -> Optional[float]:
        """Fraction of the streamed windows' wall time spent starved for
        input so far (None on synthetic runs)."""
        if not self._has_data_path:
            return None
        if self._cum_data_window_sec <= 0:
            return 0.0
        return max(0.0, min(self._cum_data_wait_sec / self._cum_data_window_sec, 1.0))

    def step_window(
        self,
        *,
        last_step: int,
        losses: List[float],
        window_mean_step_time_sec: float,
        data_wait_sec: Optional[float] = None,
        records_skipped: Optional[int] = None,
    ) -> None:
        """Record one synced window: per-window stats + anomaly screening.

        Call ONLY after the loop blocked on the window's last loss (the
        values are real, and the device is already fenced — no extra
        sync). Samples the allocator HBM high-water mark, updates the
        cumulative-throughput accounting, screens for NaN losses and
        step-time spikes, and prints a heartbeat when the interval is due.
        """
        n = len(losses)
        if n == 0:
            return
        self._last_step = last_step
        loss = losses[-1]
        self._last_loss = loss
        self._cum_tokens += n * self.tokens_per_step
        self._cum_window_sec += n * window_mean_step_time_sec
        tps = (self._cum_tokens / self._cum_window_sec
               if self._cum_window_sec > 0 else 0.0)
        hbm = None
        hbm_now = None
        try:
            from ..utils.metrics import hbm_bytes_in_use, peak_hbm_bytes

            hbm = peak_hbm_bytes()
            hbm_now = hbm_bytes_in_use()
        except Exception:
            pass
        if hbm is not None:
            # Live high-water mark for the heartbeat channel: the
            # liveness probe surfaces memory pressure mid-run.
            self._last_hbm_peak_gib = round(hbm / 2**30, 3)
        # Streaming-data fields (stream runs only): the window's wait for
        # input and the quarantine total make the stall timeline
        # reconstructible from the JSONL alone.
        data_fields: Dict[str, Any] = {}
        if data_wait_sec is not None:
            self._has_data_path = True
            self._cum_data_wait_sec += max(data_wait_sec, 0.0)
            self._cum_data_window_sec += n * window_mean_step_time_sec
            data_fields["data_wait_sec"] = round(data_wait_sec, 6)
        if records_skipped is not None:
            self._has_data_path = True
            self._records_skipped = int(records_skipped)
            data_fields["records_skipped"] = int(records_skipped)
        self._emit(
            "step_window",
            step=last_step,
            steps_in_window=n,
            # Non-finite -> null: json.dumps would otherwise write the
            # non-spec NaN/Infinity tokens and break strict consumers.
            loss=round(loss, 6) if math.isfinite(loss) else None,
            window_mean_step_time_sec=round(window_mean_step_time_sec, 6),
            cum_tokens=self._cum_tokens,
            tokens_per_sec=round(tps, 3),
            peak_hbm_bytes=hbm,
            hbm_bytes_in_use=hbm_now,
            phase=self._phase,
            **data_fields,
        )
        self._screen_anomalies(last_step, losses, window_mean_step_time_sec)
        self._heartbeat(last_step, loss, tps, window_mean_step_time_sec)

    def _screen_anomalies(
        self, last_step: int, losses: List[float], dt: float
    ) -> None:
        for l in losses:
            if l != l or math.isinf(l):
                self._n_anomalies += 1
                self._nan_anomalies += 1
                self._emit("anomaly", kind="nan_loss", step=last_step,
                           detail="non-finite loss in window")
                break  # one nan event per window is signal enough
        history = self._window_dts
        if len(history) >= SPIKE_MIN_HISTORY:
            med = sorted(history)[len(history) // 2]
            if self._open_spike is None and dt > SPIKE_FACTOR * med:
                self._n_anomalies += 1
                self._open_spike = last_step
                self._spike_dts = [dt]
                self._emit(
                    "anomaly", kind="step_time_spike", step=last_step,
                    detail=(f"window mean {dt:.4f}s > {SPIKE_FACTOR}x "
                            f"median {med:.4f}s"),
                )
            elif self._open_spike is not None:
                if dt <= SPIKE_RESOLVE_FACTOR * med:
                    self._emit("anomaly_resolved", kind="step_time_spike",
                               step=last_step,
                               opened_at_step=self._open_spike)
                    self._open_spike = None
                else:
                    self._spike_dts.append(dt)
                    if len(self._spike_dts) >= SPIKE_REBASELINE_WINDOWS:
                        # Sustained slowdown, not a stall: adopt the new
                        # level as the baseline so the run can still close
                        # with zero open anomalies (the published step-time
                        # stats carry the slowdown honestly either way).
                        self._emit(
                            "anomaly_resolved", kind="step_time_spike",
                            step=last_step,
                            opened_at_step=self._open_spike,
                            rebaselined=True,
                            detail=(f"rebaselined after "
                                    f"{len(self._spike_dts)} windows at "
                                    "the new level"),
                        )
                        self._open_spike = None
                        # The trailing append below re-adds this window.
                        self._window_dts = list(self._spike_dts[:-1])
        # Spike windows stay out of the history so one stall cannot drag
        # the median up and mask the next stall.
        if self._open_spike is None:
            self._window_dts.append(dt)

    def _heartbeat(self, step: int, loss: float, tps: float, dt: float) -> None:
        if not (self.enabled and self.is_main):
            return
        now = time.perf_counter()
        if (self._last_hb_t is not None
                and now - self._last_hb_t < self.heartbeat_every_sec):
            return
        self._last_hb_t = now
        payload = {
            "arm": self.arm,
            "step": step,
            "total_steps": self.total_steps,
            "loss": round(loss, 4) if math.isfinite(loss) else None,
            "tokens_per_sec": round(tps, 1),
            "window_mean_step_time_sec": round(dt, 4),
            "phase": self._phase,
            "ts": round(time.time(), 3),
        }
        if self._last_hbm_peak_gib is not None:
            # Live memory pressure in the scrape channel
            # (scripts/liveness_probe.sh surfaces it mid-run).
            payload["hbm_peak_gib"] = self._last_hbm_peak_gib
        if self._has_data_path:
            # Input-path pressure in the scrape channel: an input-bound run
            # is visible mid-run, and a salvaged partial row carries the
            # stall and skip accounting.
            payload["data_stall_frac"] = round(self.data_stall_frac or 0.0, 4)
            payload["records_skipped"] = self._records_skipped or 0
        payload.update(self.meta)
        # flush=True: heartbeats must reach a pipe/pod log immediately —
        # a block-buffered stdout would hold them hostage past a SIGKILL.
        print(f"{HEARTBEAT_MARKER} {json.dumps(payload)}", flush=True)

    def emergency_heartbeat(
        self, *, reason: str, extra: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Print one final heartbeat NOW, ignoring the cadence.

        The preemption path's last word on stdout: carries ``reason``
        (e.g. ``preempted``) plus whatever the emergency stop knows
        (``emergency_checkpoint_step``), so collect_results.sh stamps the
        salvaged partial row from the emergency checkpoint's metadata
        rather than an older cadenced heartbeat.
        """
        if not (self.enabled and self.is_main):
            return
        self._last_hb_t = time.perf_counter()
        loss = self._last_loss
        payload = {
            "arm": self.arm,
            "step": self._last_step,
            "total_steps": self.total_steps,
            "loss": (round(loss, 4)
                     if loss is not None and math.isfinite(loss) else None),
            "tokens_per_sec": round(
                self._cum_tokens / self._cum_window_sec
                if self._cum_window_sec > 0 else 0.0, 1),
            "phase": self._phase,
            "reason": reason,
            "ts": round(time.time(), 3),
        }
        if self._last_hbm_peak_gib is not None:
            payload["hbm_peak_gib"] = self._last_hbm_peak_gib
        if self._has_data_path:
            # Input-path pressure in the scrape channel: an input-bound run
            # is visible mid-run, and a salvaged partial row carries the
            # stall and skip accounting.
            payload["data_stall_frac"] = round(self.data_stall_frac or 0.0, 4)
            payload["records_skipped"] = self._records_skipped or 0
        payload.update(self.meta)
        payload.update(extra or {})
        print(f"{HEARTBEAT_MARKER} {json.dumps(payload)}", flush=True)

    # ------------------------------------------------------------------
    # Shutdown
    # ------------------------------------------------------------------

    def _summary_fields(self) -> Dict[str, Any]:
        fields = {
            "last_step": self._last_step,
            "phase": self._phase,
            "phase_times": {k: round(v, 6)
                            for k, v in self.phase_times().items()},
            "wall_time_total_sec": round(self.wall_time_total(), 6),
            "n_anomalies": self._n_anomalies,
            "n_unresolved_anomalies": self.n_unresolved_anomalies,
        }
        if self._has_data_path:
            # The terminal event carries the input-path accounting too: a
            # JSONL alone still shows whether the run was input-bound or
            # healed records.
            fields["data_stall_frac"] = round(self.data_stall_frac or 0.0, 6)
            fields["records_skipped"] = self._records_skipped or 0
        if self.meta.get("resumed"):
            # Stitched runs carry their accounting into the terminal
            # event too, so a JSONL alone (no result row) still shows
            # the run was not a clean single-attempt measurement.
            fields["resumed"] = True
            fields["n_restarts"] = self.meta.get("n_restarts", 1)
            if self.meta.get("resume_geometry_changed"):
                fields["resume_geometry_changed"] = True
        return fields

    def discard(self) -> None:
        """Close WITHOUT a terminal event and delete the JSONL. Idempotent.

        For refusal paths that must leave no trail: opening the recorder
        truncated ``telemetry_<arm>.jsonl``, so a refused re-invocation
        (e.g. a resume with nothing left to run) would otherwise replace
        a completed run's telemetry with a ``run_aborted`` stub — and the
        validator would then reject the completed run's published row as
        "crashed". Only sane before any step windows were recorded.
        """
        if self._closed:
            return
        self._closed = True
        path = self.path
        self._teardown()
        if path is not None:
            try:
                os.remove(path)
            except OSError:
                pass

    def abort(self, reason: str) -> None:
        """Emit ``run_aborted`` and release the hooks. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._emit("run_aborted", reason=reason, **self._summary_fields())
        self._teardown()

    def close(self, status: str = "ok") -> Dict[str, float]:
        """End the open phase, emit ``run_end``, return the phase times."""
        if self._closed:
            return dict(self._phase_times)
        now = time.perf_counter()
        if self._phase is not None:
            dur = now - self._phase_t0
            self._phase_times[self._phase] = (
                self._phase_times.get(self._phase, 0.0) + dur
            )
            self._emit("phase_end", phase=self._phase, dur_sec=round(dur, 6))
            self._phase = None
        self._closed = True
        self._emit("run_end", status=status, **self._summary_fields())
        self._teardown()
        return dict(self._phase_times)

    def _teardown(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None
        if sys.excepthook is self._excepthook:
            sys.excepthook = self._prev_excepthook
        try:
            atexit.unregister(self._atexit_flush)
        except Exception:
            pass

    def _excepthook(self, etype, value, tb) -> None:
        self.abort(f"exception:{etype.__name__}: {value}")
        self._prev_excepthook(etype, value, tb)

    def _atexit_flush(self) -> None:
        # Reached only when neither close() nor abort() ran (e.g. a
        # sys.exit mid-run): record that the run ended without a verdict.
        try:
            self.abort("atexit:process exited before run_end")
        except Exception:
            pass
