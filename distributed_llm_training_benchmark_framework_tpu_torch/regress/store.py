"""The run registry: append-only, content-addressed benchmark history.

Port of ``distributed_llm_training_benchmark_framework_tpu/regress/store.py``,
with the same record schema, ids, :func:`config_key` and baseline rules.
The port keeps a registry of its own, apart from JAX's, because
:func:`config_key` has no backend axis: an H100 row must never gate against
(or seed the noise floor of) a TPU lineage. So:

- the default root is ``results/registry_torch`` and its variable
  ``REGRESS_REGISTRY_TORCH`` (JAX: ``results/registry``, whose committed
  seed holds TPU v5e numbers, and ``REGRESS_REGISTRY``);
- the environment fingerprint names ``torch_version`` and the
  ``cuda_version`` torch was built with, not ``jax_version``, beside the
  row's ``backend`` and ``device_kind``;
- :func:`ingest_legacy` is refused: the repo-root ``BENCH_r*.json`` /
  ``MULTICHIP_r*.json`` snapshots are TPU-era records, not the port's
  history;
- within the port's registry, a baseline and a noise-floor sample share
  the candidate's :func:`device_of` (the row's ``backend`` and
  ``device_kind``) as well as its :func:`config_key`, which stays JAX's:
  a ``--device cpu`` run and an H100 run of one geometry are one lineage
  for ``config_key`` but never each other's baseline.

Every other layer of the framework produces evidence about ONE run — a
result row (utils.metrics), a telemetry JSONL (telemetry.recorder), a
salvaged partial (scripts/collect_results.sh) — and until this module
nothing accumulated it: suite runs were compared by eyeball against stale
markdown. The registry is the persistence layer the regression gate
(``regress.compare``) and the trend reports read from.

Layout (default root ``results/registry_torch/``, override with the
``REGRESS_REGISTRY_TORCH`` env var or every CLI's ``--registry``):

    registry_meta.json            {"schema_version": N} — writer version
    index.jsonl                   one line per ingest, append-only:
                                  {seq, record_id, arm, status,
                                   metric_name, metric_value,
                                   ingested_at, source}
    records/<arm>/<record_id>.json   the full record

Properties the gate relies on:

- **Append-only.** Records are never rewritten; ``index.jsonl`` only
  grows. Ingest order (the ``seq`` counter) is the registry's clock —
  "last known good" means "highest seq with status ok", so wall-clock
  skew between hosts cannot reorder history.
- **Content-addressed.** ``record_id`` is a sha256 prefix over the
  canonical JSON of the *measurement* (arm, status, source, metric,
  result row, windows) — re-ingesting the same artifacts is a no-op, so
  the suite's finish path may blindly re-scan a results dir that was
  already ingested. The environment fingerprint is deliberately outside
  the hash: the same measurement ingested from two checkouts must not
  mint two records.
- **Partial runs are stored but never baselines.** A heartbeat-salvaged
  ``partial_<arm>.json`` (NaN scaling efficiency in metrics.csv) ingests
  with ``status: "partial"`` — visible in ``trend``, excluded from
  ``baseline()`` and from trend superlatives. A truncated run's
  last-window rate is not a run mean and must never anchor a verdict.
- **Resumed runs join partials in the never-baseline set.** A stitched
  run (``result.resumed`` true — chaos round, docs/FAULT_TOLERANCE.md)
  is an honest *record* but a dishonest *baseline*: its first timed
  window folds in the restore recompile and its step population spans
  two attempts, so ``baseline()``/``history_values()`` skip it the same
  way they skip partials. Rolled-back runs (``result.n_rollbacks`` > 0 —
  the numerics sentinel healed them in-process, self-healing round) are
  excluded for the same reason: their replayed region ran twice and the
  trip itself says the run hit a numerics incident.
- **Known-regressed records are banked, not adopted.** When the gate
  verdicts a regression, the candidate's record_id is appended to
  ``banked.jsonl`` (append-only, bank/unbank action lines): "last known
  good" then *skips* the banked record instead of adopting it as the
  next baseline — without this, one accepted regression silently
  ratchets the floor down for every later run. ``regress bank/unbank``
  manage the set by hand.
- **Schema drift refuses loudly.** Records and the registry meta carry
  ``schema_version``; a reader that encounters a NEWER version raises
  :class:`SchemaDrift` instead of guessing at fields it does not know —
  the same posture the JAX package's graftcheck takes for budgets frozen
  on another version (exit 2, regenerate/upgrade, never silently compare).
"""

from __future__ import annotations

import glob
import hashlib
import json
import math
import os
import subprocess
import time
from typing import Any, Dict, List, Optional, Tuple

#: Version of the record schema THIS reader/writer speaks. Bump on any
#: field change that an old reader would misinterpret; readers accept
#: <= their own version and refuse anything newer.
REGISTRY_SCHEMA_VERSION = 1

META_FILENAME = "registry_meta.json"
INDEX_FILENAME = "index.jsonl"
RECORDS_DIRNAME = "records"
BANKED_FILENAME = "banked.jsonl"

#: Statuses a record may carry. Only "ok" records are baseline-eligible.
STATUSES = ("ok", "partial")

#: The variable naming the port's registry root (JAX's is REGRESS_REGISTRY).
REGISTRY_ENV = "REGRESS_REGISTRY_TORCH"
#: The port's default root under the repo (JAX's is results/registry).
DEFAULT_REGISTRY_DIRNAME = "registry_torch"

#: Why ``ingest --legacy`` is refused in the port.
LEGACY_REFUSED = (
    "the repo-root BENCH_r*.json / MULTICHIP_r*.json snapshots are TPU-era "
    "records of the JAX package; the port's registry holds only the port's "
    "own runs (seed it with `ingest --results-dir` or the bench's --regress on)"
)


class SchemaDrift(RuntimeError):
    """A record (or the registry meta) is newer than this reader."""


def default_registry_root() -> str:
    """``REGRESS_REGISTRY_TORCH`` env var, else ``<repo>/results/registry_torch``.

    The repo root is located relative to this file so bench.py, the
    scripts (which ``cd`` to the repo root) and out-of-tree callers all
    resolve the same default.
    """
    env = os.environ.get(REGISTRY_ENV)
    if env:
        return env
    repo = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    return os.path.join(repo, "results", DEFAULT_REGISTRY_DIRNAME)


def _sanitize(obj: Any) -> Any:
    """Non-finite floats -> None, recursively.

    Partial rows legitimately carry NaN (scaling efficiency); canonical
    JSON (allow_nan=False) would crash on them and non-strict NaN tokens
    would break strict consumers, so the registry stores null — the same
    convention the telemetry channel uses for non-finite losses.
    """
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def _canonical(payload: Dict[str, Any]) -> str:
    return json.dumps(payload, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)


def record_id_for(payload: Dict[str, Any]) -> str:
    """sha256 prefix over the measurement fields (see module docstring)."""
    # ``source`` stays OUT of the hash: the harness's result_<arm>.json and
    # the log-scraped result.json of the SAME run carry identical rows and
    # must dedupe to one record despite their different filenames.
    hashed = {
        k: payload.get(k)
        for k in ("arm", "status", "metric", "result", "windows",
                  "tokens_per_step")
    }
    return hashlib.sha256(_canonical(hashed).encode()).hexdigest()[:16]


def git_sha() -> Optional[str]:
    """Best-effort short sha of the repo this module lives in."""
    repo = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=repo,
            capture_output=True, text=True, timeout=10,
        )
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except Exception:
        return None


def env_fingerprint(result_row: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Run-environment identity stored beside (not hashed into) a record.

    Answers "is this delta a code change or an environment change" during
    triage: git sha, torch version (and the CUDA version it was built
    with), device kind/backend, and the mesh geometry + attention impl
    from the result row when one is given.
    """
    fp: Dict[str, Any] = {"git_sha": git_sha()}
    try:
        import torch

        fp["torch_version"] = torch.__version__
        fp["cuda_version"] = torch.version.cuda
    except Exception:
        fp["torch_version"] = None
        fp["cuda_version"] = None
    r = result_row or {}
    fp["device_kind"] = r.get("device_kind") or None
    fp["backend"] = r.get("backend") or None
    fp["attention_impl"] = r.get("attention_impl") or None
    # Scheduling-relevant XLA flags (latency-hiding scheduler, async
    # collectives — utils.platform.scheduler_flags_fingerprint): an env
    # change that moves the collective schedule must be visible in triage.
    fp["xla_scheduler_flags"] = r.get("xla_scheduler_flags") or ""
    # Collective-matmul tp fusion (round 15): a structurally different
    # projection schedule — triage must see it beside the scheduler flags.
    fp["tp_collective_matmul"] = bool(r.get("tp_collective_matmul"))
    fp["mesh"] = {
        "world_size": r.get("world_size"),
        "tensor_parallel": r.get("tensor_parallel", 1),
        "sequence_parallel": r.get("sequence_parallel", 1),
        "pipeline_parallel": r.get("pipeline_parallel", 1),
        "expert_parallel": r.get("expert_parallel", 1),
    }
    return fp


def config_key(record: Dict[str, Any]) -> Tuple:
    """Geometry/config axes a baseline must share with its candidate.

    Comparing a b2xaccum2 run against a b1xaccum4 baseline would verdict
    a config change as a perf change — the same trap parse_metrics's
    scaling-efficiency grouping guards with its extended group columns.
    """
    r = record.get("result") or {}
    return tuple(
        r.get(k) for k in (
            "model_family", "strategy", "tier", "seq_len", "world_size",
            "per_device_batch", "grad_accum", "attention_impl", "sync_every",
            "tensor_parallel", "sequence_parallel", "pipeline_parallel",
            "pipeline_schedule", "expert_parallel", "n_experts",
            "param_dtype", "causal", "ring_zigzag",
            # Run length is methodology, not noise: a 12-step smoke value
            # must not enter a 100-step lineage's noise floor (short runs
            # over-weight the warm caches and the first windows).
            "steps", "warmup_steps",
        )
    ) + (
        record.get("metric", {}).get("name"),
        # Profiling is methodology too: the trace bracket around the timed
        # window adds collection overhead, so a PROFILE=1 run must not
        # gate against (or feed the noise floor of) an unprofiled lineage.
        # Anatomy fields are non-null exactly when the run profiled.
        r.get("comms_exposed_frac") is not None,
        # The latency-hiding scheduler changes the collective schedule —
        # a flagged run is a different measurement lineage than an
        # unflagged one (legacy records carry no field -> "" -> they stay
        # in the unflagged lineage, byte-compatible with their history).
        r.get("xla_scheduler_flags") or "",
        # Remat policy trades HBM for recompute: every --remat-sweep
        # point is its own lineage (absent on legacy rows -> None).
        r.get("remat_policy"),
        # The collective-matmul tp fusion replaces the projection
        # collectives with a ppermute ring — a different collective
        # schedule, so cmm and plain-tp runs are separate lineages
        # (legacy rows carry no field -> False -> the plain lineage).
        bool(r.get("tp_collective_matmul")),
        # Input path is methodology: a streaming (--data-path) run pays
        # host-read + device-put costs the synthetic table never does, so
        # it must not gate against (or feed the noise floor of) the
        # synthetic lineage. Legacy rows carry no field -> normalized to
        # "synthetic" so existing history stays one lineage.
        r.get("data_mode") or "synthetic",
    )


def device_of(record: Dict[str, Any]) -> Tuple:
    """(backend, device_kind) of a record's row: the port's device axis
    beside :func:`config_key` (module docstring)."""
    r = record.get("result") or {}
    return (r.get("backend") or None, r.get("device_kind") or None)


def make_record(
    *,
    arm: str,
    result_row: Dict[str, Any],
    windows: Optional[List[Dict[str, Any]]] = None,
    tokens_per_step: int = 0,
    status: str = "ok",
    source: str = "",
    metric: Optional[Dict[str, Any]] = None,
    masked_windows: int = 0,
) -> Dict[str, Any]:
    """Assemble a schema-versioned record payload (not yet ingested).

    ``metric`` defaults to the row's global ``tokens_per_sec``; legacy
    and bench.py callers override it (per-chip headline value).
    ``windows`` are the timed sync windows extracted from the run's
    telemetry JSONL (``stats.timed_windows``) — empty when the run had
    no telemetry file (bench.py in-process arms, legacy snapshots), in
    which case comparisons fall back to scalar-vs-history mode.
    ``masked_windows`` counts spike-flagged windows the extraction
    excluded (additive key, present only when nonzero — and outside the
    content hash, like ``source``, so masking accounting can never split
    one measurement into two records).
    """
    if status not in STATUSES:
        raise ValueError(f"unknown record status {status!r} "
                         f"(expected one of {STATUSES})")
    if metric is None:
        metric = {
            "name": "tokens_per_sec",
            "value": result_row.get("tokens_per_sec"),
            "higher_is_better": True,
        }
    payload = _sanitize({
        "schema_version": REGISTRY_SCHEMA_VERSION,
        "arm": arm,
        "status": status,
        "source": source,
        "metric": metric,
        "result": dict(result_row),
        "windows": list(windows or []),
        "tokens_per_step": int(tokens_per_step),
        "env": env_fingerprint(result_row),
    })
    if masked_windows:
        payload["masked_windows"] = int(masked_windows)
    payload["record_id"] = record_id_for(payload)
    return payload


def check_record_version(record: Dict[str, Any], origin: str = "") -> None:
    ver = record.get("schema_version")
    if not isinstance(ver, int) or ver > REGISTRY_SCHEMA_VERSION:
        raise SchemaDrift(
            f"record{' ' + origin if origin else ''} carries schema_version "
            f"{ver!r} but this reader speaks {REGISTRY_SCHEMA_VERSION} — "
            "refusing to interpret a newer schema; upgrade the tooling"
        )


class Registry:
    """Handle on one registry root. Opening never creates; ingest does."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or default_registry_root()
        # Read caches, invalidated/extended by ingest: every gate/compare
        # path walks the index and re-loads records repeatedly, and one
        # Registry instance serves a whole CLI command — without these,
        # `gate --all` on an accumulating registry is O(arms x records^2)
        # file IO.
        self._index_cache: Optional[List[Dict[str, Any]]] = None
        self._record_cache: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._check_meta()

    # -- plumbing ----------------------------------------------------------

    @property
    def index_path(self) -> str:
        return os.path.join(self.root, INDEX_FILENAME)

    @property
    def meta_path(self) -> str:
        return os.path.join(self.root, META_FILENAME)

    def exists(self) -> bool:
        return os.path.exists(self.index_path)

    def _check_meta(self) -> None:
        if not os.path.exists(self.meta_path):
            return
        try:
            meta = json.load(open(self.meta_path))
        except (json.JSONDecodeError, OSError) as e:
            raise SchemaDrift(f"unreadable {self.meta_path}: {e}")
        ver = meta.get("schema_version")
        if not isinstance(ver, int) or ver > REGISTRY_SCHEMA_VERSION:
            raise SchemaDrift(
                f"registry at {self.root} was written with schema_version "
                f"{ver!r} but this reader speaks {REGISTRY_SCHEMA_VERSION} "
                "— refusing to ingest into (or read) a newer registry"
            )

    def _record_path(self, arm: str, record_id: str) -> str:
        return os.path.join(self.root, RECORDS_DIRNAME, arm,
                            f"{record_id}.json")

    # -- writes ------------------------------------------------------------

    def ingest(self, payload: Dict[str, Any]) -> Tuple[Dict[str, Any], bool]:
        """Write one record; returns (record, created).

        Idempotent on content: an already-present record_id is a no-op
        (the append-only index is not re-appended either).
        """
        check_record_version(payload, payload.get("record_id", ""))
        rid = payload.get("record_id") or record_id_for(payload)
        payload = dict(payload, record_id=rid)
        path = self._record_path(payload["arm"], rid)
        if os.path.exists(path):
            existing = json.load(open(path))
            # Self-heal a torn ingest: a crash between the record write
            # and the index append (the exact environment this registry
            # serves — preempted pods, killed suites) leaves the file on
            # disk but invisible to every index-driven read. The index is
            # the registry's clock, so repair = append now.
            if not any(l["record_id"] == rid for l in self.index_lines()):
                self._append_index(existing)
            return existing, False
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if not os.path.exists(self.meta_path):
            os.makedirs(self.root, exist_ok=True)
            with open(self.meta_path, "w") as f:
                json.dump({"schema_version": REGISTRY_SCHEMA_VERSION,
                           "created_by": "regress.store"}, f, indent=2)
                f.write("\n")
        payload = dict(payload, ingested_at=round(time.time(), 3))
        with open(path, "w") as f:
            f.write(json.dumps(payload, indent=2, sort_keys=True))
            f.write("\n")
        self._record_cache[(payload["arm"], rid)] = payload
        self._append_index(payload)
        return payload, True

    def _append_index(self, payload: Dict[str, Any]) -> None:
        index_line = {
            "seq": len(self.index_lines()),
            "record_id": payload["record_id"],
            "arm": payload["arm"],
            "status": payload["status"],
            "metric_name": payload["metric"].get("name"),
            "metric_value": payload["metric"].get("value"),
            "source": payload.get("source", ""),
            "ingested_at": payload.get("ingested_at",
                                       round(time.time(), 3)),
        }
        with open(self.index_path, "a") as f:
            f.write(json.dumps(index_line, sort_keys=True) + "\n")
        if self._index_cache is not None:
            self._index_cache.append(index_line)

    # -- banked regressions ------------------------------------------------

    @property
    def banked_path(self) -> str:
        return os.path.join(self.root, BANKED_FILENAME)

    def banked_ids(self) -> set:
        """Record ids currently banked as known regressions.

        ``banked.jsonl`` is append-only action lines ({record_id, action
        bank|unbank, reason, at}); the effective set is the fold, so the
        registry's everything-is-append-only invariant holds here too.
        """
        if not os.path.exists(self.banked_path):
            return set()
        banked: set = set()
        with open(self.banked_path) as f:
            for raw in f:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    line = json.loads(raw)
                except json.JSONDecodeError:
                    # A torn append (process killed mid-write — the very
                    # preemption this ledger serves) must not wedge every
                    # gate/trend/baseline path; the lost action is at
                    # worst one bank the next gate run re-banks.
                    continue
                if line.get("action", "bank") == "bank":
                    banked.add(line["record_id"])
                else:
                    banked.discard(line["record_id"])
        return banked

    def bank(self, record_id: str, reason: str = "") -> bool:
        """Mark a record as a known regression; returns True when new.

        Banked records stay visible (trend, compare) but ``baseline()``
        and ``history_values()`` skip them — "last known good" must skip
        a banked regression instead of adopting it. Idempotent.
        """
        if record_id in self.banked_ids():
            return False
        with open(self.banked_path, "a") as f:
            f.write(json.dumps({
                "record_id": record_id, "action": "bank",
                "reason": reason, "at": round(time.time(), 3),
            }, sort_keys=True) + "\n")
        return True

    def unbank(self, record_id: str, reason: str = "") -> bool:
        """Lift a bank (e.g. the regression was accepted as the new
        normal and re-measured); returns True when it was banked."""
        if record_id not in self.banked_ids():
            return False
        with open(self.banked_path, "a") as f:
            f.write(json.dumps({
                "record_id": record_id, "action": "unbank",
                "reason": reason, "at": round(time.time(), 3),
            }, sort_keys=True) + "\n")
        return True

    # -- reads -------------------------------------------------------------

    def index_lines(self) -> List[Dict[str, Any]]:
        if self._index_cache is not None:
            return self._index_cache
        if not os.path.exists(self.index_path):
            return []
        lines: List[Dict[str, Any]] = []
        with open(self.index_path) as f:
            for raw in f:
                raw = raw.strip()
                if raw:
                    lines.append(json.loads(raw))
        self._index_cache = lines
        return lines

    def arms(self) -> List[str]:
        return sorted({l["arm"] for l in self.index_lines()})

    def load(self, arm: str, record_id: str) -> Dict[str, Any]:
        cached = self._record_cache.get((arm, record_id))
        if cached is not None:
            return cached
        path = self._record_path(arm, record_id)
        record = json.load(open(path))
        check_record_version(record, os.path.basename(path))
        self._record_cache[(arm, record_id)] = record
        return record

    def resolve(self, selector: str) -> Dict[str, Any]:
        """A record from an id prefix (unique across the registry)."""
        matches = [l for l in self.index_lines()
                   if l["record_id"].startswith(selector)]
        if not matches:
            raise KeyError(f"no record matching id prefix {selector!r}")
        ids = {m["record_id"] for m in matches}
        if len(ids) > 1:
            raise KeyError(
                f"id prefix {selector!r} is ambiguous ({sorted(ids)})"
            )
        m = matches[0]
        return self.load(m["arm"], m["record_id"])

    def records(self, arm: str) -> List[Dict[str, Any]]:
        """Full records for one arm, in ingest (seq) order."""
        return [
            self.load(l["arm"], l["record_id"])
            for l in self.index_lines() if l["arm"] == arm
        ]

    def latest(self, arm: str) -> Optional[Dict[str, Any]]:
        recs = self.records(arm)
        return recs[-1] if recs else None

    def baseline(
        self,
        arm: str,
        *,
        exclude_record_id: Optional[str] = None,
        match_config_of: Optional[Dict[str, Any]] = None,
    ) -> Optional[Dict[str, Any]]:
        """Last known good: newest ok record, never a partial one.

        ``exclude_record_id`` keeps a candidate from being its own
        baseline; ``match_config_of`` restricts to records sharing the
        candidate's :func:`config_key` so a geometry change can never
        masquerade as a perf delta. Banked regressions and resumed
        (stitched) rows are skipped too — neither is a clean measurement
        for anything to be judged against (module docstring).
        """
        for rec in self._eligible(arm, exclude_record_id, match_config_of):
            return rec
        return None

    def _eligible(
        self, arm: str,
        exclude_record_id: Optional[str],
        match_config_of: Optional[Dict[str, Any]],
    ):
        """Newest-first records eligible as baseline / noise-floor input.

        THE baseline-eligibility filter chain, shared by :meth:`baseline`,
        :meth:`history_values` and :meth:`result_history_values` so the
        primary and secondary noise floors can never disagree about which
        runs count: status ok, unbanked, not resumed, not rolled-back
        (sentinel-healed, ``n_rollbacks`` > 0), not supervisor-recovered
        (``supervision.n_attempts`` > 1) — the
        resume_geometry_changed check is defense in depth for a row whose
        accounting broke (flag without resumed; docs/FAULT_TOLERANCE.md)
        — not the candidate itself, and sharing the candidate's
        :func:`config_key` and :func:`device_of`.
        """
        want = config_key(match_config_of) if match_config_of else None
        want_device = device_of(match_config_of) if match_config_of else None
        banked = self.banked_ids()
        for rec in reversed(self.records(arm)):
            if rec.get("status") != "ok":
                continue
            if rec.get("record_id") in banked:
                continue
            res = rec.get("result") or {}
            if res.get("resumed") or res.get("resume_geometry_changed"):
                continue
            if res.get("n_rollbacks"):
                continue
            # Supervisor-recovered rows (runtime/supervisor.py stamps the
            # recovery history only when recovery actually happened, i.e.
            # n_attempts > 1): the published measurement spans a restart —
            # recompile, possibly a geometry shrink leg — so like resumed
            # rows it is never a clean baseline/noise-floor sample.
            if (res.get("supervision") or {}).get("n_attempts", 1) > 1:
                continue
            if exclude_record_id and rec.get("record_id") == exclude_record_id:
                continue
            if want is not None and (config_key(rec) != want
                                     or device_of(rec) != want_device):
                continue
            yield rec

    def history_values(
        self, arm: str, *, metric_name: str,
        exclude_record_id: Optional[str] = None,
        match_config_of: Optional[Dict[str, Any]] = None, limit: int = 8,
    ) -> List[float]:
        """Recent ok-record metric values — the noise-floor sample.

        ``match_config_of`` restricts to records sharing the candidate's
        :func:`config_key`: the noise floor must measure run-to-run
        jitter of ONE configuration, not the spread across historical
        config changes (a past legitimate improvement would otherwise
        inflate the floor until it masked real regressions). Banked
        regressions and resumed rows stay out for the same reason — a
        stitched run's recompile-polluted value is not run-to-run jitter.
        """
        vals: List[float] = []
        for rec in self._eligible(arm, exclude_record_id, match_config_of):
            m = rec.get("metric") or {}
            if m.get("name") != metric_name or m.get("value") is None:
                continue
            vals.append(float(m["value"]))
            if len(vals) >= limit:
                break
        return list(reversed(vals))

    def result_history_values(
        self, arm: str, *, result_key: str,
        exclude_record_id: Optional[str] = None,
        match_config_of: Optional[Dict[str, Any]] = None, limit: int = 8,
    ) -> List[float]:
        """Same-config history of a RESULT-ROW field (secondary metrics).

        The per-metric noise-floor sample behind the secondary-metric
        gate (``stats.SECONDARY_METRICS``): MFU, peak HBM and the
        step-anatomy fractions live in the result row rather than the
        headline ``metric`` slot, so their run-to-run spread is read from
        there — with exactly the baseline-eligibility filters
        :meth:`history_values` applies (the shared :meth:`_eligible`
        chain: ok-only, unbanked, non-resumed, matching config key).
        """
        vals: List[float] = []
        for rec in self._eligible(arm, exclude_record_id, match_config_of):
            v = (rec.get("result") or {}).get(result_key)
            if v is None or not isinstance(v, (int, float)):
                continue
            vals.append(float(v))
            if len(vals) >= limit:
                break
        return list(reversed(vals))


# ---------------------------------------------------------------------------
# Ingest paths: results dirs, and the legacy repo-root snapshots
# ---------------------------------------------------------------------------


def _windows_for_result(
    result_path: str, arm: str,
) -> Tuple[List[Dict[str, Any]], int, int]:
    """(timed windows, tokens_per_step, n spike-masked) from the sibling JSONL.

    Window-level anomaly masking (benchreg follow-up (c)): windows the
    recorder flagged inside an open step-time spike are excluded from the
    stored comparison sample — they measure the stall, not the code — and
    their count rides the record as ``masked_windows`` so the verdict
    line can say the masking happened.
    """
    tpath = os.path.join(os.path.dirname(result_path), f"telemetry_{arm}.jsonl")
    if not os.path.exists(tpath):
        return [], 0, 0
    from ..telemetry import read_events
    from . import stats

    try:
        events = read_events(tpath)
    except (OSError, ValueError):
        return [], 0, 0
    meta = next((e for e in events if e.get("event") == "run_meta"), {})
    kept, masked = stats.split_masked_windows(events)
    return kept, int(meta.get("tokens_per_step", 0) or 0), len(masked)


def ingest_results_dir(
    reg: Registry, results_dir: str,
) -> List[Tuple[Dict[str, Any], bool]]:
    """Scan a suite results tree: result_<arm>.json + partial_<arm>.json.

    Full rows ingest as ``ok`` with their telemetry windows when the
    sibling JSONL exists; heartbeat-salvaged partials ingest as
    ``partial`` (baseline-ineligible — the satellite contract pinned by
    tests/test_regress.py). Bare ``result.json`` scrapes (no arm in the
    filename) reconstruct the arm slug from the row itself.
    """
    from ..utils.metrics import arm_slug

    out: List[Tuple[Dict[str, Any], bool]] = []
    seen: set = set()
    for path in sorted(glob.glob(os.path.join(results_dir, "**",
                                              "result*.json"),
                                 recursive=True)):
        try:
            row = json.load(open(path))
        except (json.JSONDecodeError, OSError):
            continue
        if not isinstance(row, dict) or "tokens_per_sec" not in row:
            continue
        base = os.path.basename(path)
        if base.startswith("result_") and base.endswith(".json"):
            arm = base[len("result_"):-len(".json")]
        else:
            try:
                arm = arm_slug(
                    row["strategy"], row["world_size"], row["seq_len"],
                    row["tier"], row.get("model_family", "tinygpt"),
                )
            except KeyError:
                continue
        windows, tps, n_masked = _windows_for_result(path, arm)
        rec = make_record(
            arm=arm, result_row=row, windows=windows, tokens_per_step=tps,
            status="ok", source=os.path.relpath(path, results_dir),
            masked_windows=n_masked,
        )
        if rec["record_id"] in seen:
            continue  # result_<arm>.json + scraped result.json of one run
        seen.add(rec["record_id"])
        out.append(reg.ingest(rec))
    for path in sorted(glob.glob(os.path.join(results_dir, "**",
                                              "partial_*.json"),
                                 recursive=True)):
        try:
            row = json.load(open(path))
        except (json.JSONDecodeError, OSError):
            continue
        arm = row.get("arm") or os.path.basename(path)[
            len("partial_"):-len(".json")
        ]
        row = dict(row, partial=True)
        rec = make_record(
            arm=arm, result_row=row, status="partial",
            source=os.path.relpath(path, results_dir),
            metric={
                "name": "tokens_per_sec",
                "value": row.get("tokens_per_sec"),
                "higher_is_better": True,
            },
        )
        out.append(reg.ingest(rec))
    return out


def bench_arm_slug(metric_name: str) -> str:
    """`tinygpt_tierA_seq2048_tokens_per_sec_per_chip` -> bench lineage arm.

    The bench's rows share one arm name per headline metric, so each
    bench run extends that metric's trend.
    """
    stem = metric_name
    suffix = "_tokens_per_sec_per_chip"
    if stem.endswith(suffix):
        stem = stem[: -len(suffix)]
    return f"bench_{stem}"


def record_from_bench_row(
    row: Dict[str, Any], *, source: str, extra_result: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """A registry record from one bench.py contract row (or legacy parse).

    The headline metric is per-chip tokens/sec (the contract ``value``);
    there are no telemetry windows (bench arms run with results_dir=None)
    so comparisons use scalar-vs-history mode.
    """
    result = {k: v for k, v in row.items() if k != "flagship"}
    if extra_result:
        result.update(extra_result)
    return make_record(
        arm=bench_arm_slug(str(row.get("metric", "unknown"))),
        result_row=result,
        status="ok",
        source=source,
        metric={
            "name": "tokens_per_sec_per_chip",
            "value": row.get("value"),
            "higher_is_better": True,
        },
    )


class LegacyRefused(ValueError):
    """``ingest --legacy`` in the port (see :data:`LEGACY_REFUSED`)."""


def ingest_legacy(
    reg: Registry, root: Optional[str] = None,
) -> List[Tuple[Dict[str, Any], bool]]:
    """Refused in the port: :data:`LEGACY_REFUSED`.

    JAX's seeds its registry from the repo-root BENCH_r*/MULTICHIP_r*
    snapshots, which hold TPU numbers.
    """
    raise LegacyRefused(f"ingest --legacy is refused: {LEGACY_REFUSED}")
