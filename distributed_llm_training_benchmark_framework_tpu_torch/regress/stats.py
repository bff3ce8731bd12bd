"""The shared statistics engine behind every regression verdict.

Port of ``distributed_llm_training_benchmark_framework_tpu/regress/stats.py``,
unchanged in its math, over the port's telemetry (``spike_mask_intervals``,
``step_in_spike``, ``PHASES``) and ``analysis.telemetry_report``.

One module owns the math so the gate (``regress.compare``), the telemetry
comparison (``analysis.telemetry_report --compare``) and the trend tables
cannot drift apart — the gate's acceptance contract. Everything here is
deterministic: the bootstrap is seeded, the permutation test is seeded,
and there is no wall-clock or platform dependence, so the frozen-fixture
gate proof (tests/test_regress.py) byte-reproduces everywhere.

Why distributions, not single numbers: a benchmark arm's published
tokens/sec is a mean over ~100 steps, and two means 3% apart say nothing
without the spread behind them. The flight recorder already
persists per-window step times at every sync boundary; those windows are
the per-run sample this module feeds into

- a **seeded bootstrap** for confidence intervals on the relative delta
  of means (percentile method — no normality assumption);
- a **Mann-Whitney U** rank test (normal approximation with tie
  correction) for windows-sized samples, falling back to a **seeded
  permutation test** of the mean difference when either side is tiny;
- a **noise floor** estimated from repeated same-arm runs in the
  registry (the legacy BENCH_r02..r05 snapshots alone pin bench-headline
  run-to-run noise at well under 1%), so the minimum effect a verdict
  requires is max(configured threshold, observed noise) — raw deltas
  never verdict on their own.

Verdicts are the closed set {regression, improvement, neutral,
insufficient-data}: a significant-but-tiny delta is *neutral* (below the
minimum effect), a large-but-unsupported delta is *neutral* (failed the
significance test), and too few samples is *insufficient-data*, never a
silent pass pretending to be evidence.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

#: Fewer timed windows than this on either side -> insufficient-data in
#: window mode (a 100-step, sync-every-10 run yields ~9; smoke runs less).
MIN_WINDOWS = 4
#: Two-sided significance level for the rank/permutation test.
DEFAULT_ALPHA = 0.05
#: Minimum relative effect (%) a verdict requires even when the noise
#: floor is lower — sub-2% deltas on these arms are weather, not climate.
DEFAULT_MIN_EFFECT_PCT = 2.0
#: Noise floor assumed when the registry holds too little same-arm
#: history to estimate one.
DEFAULT_NOISE_FLOOR_PCT = 1.0
#: Scalar mode has no within-run distribution, so its verdict leans
#: entirely on the history-derived noise floor — below this many
#: same-config history runs the floor is a guess, and a guess must not
#: mint a regression: the comparison reports insufficient-data instead.
#: (Window mode needs no history and verdicts from run #2.)
MIN_SCALAR_HISTORY = 3
#: Bootstrap resamples and the fixed seed (determinism is a feature: the
#: gate must give the same verdict on the same records every time).
BOOTSTRAP_N = 2000
BOOTSTRAP_SEED = 20260803
PERMUTATION_N = 4000
#: Below this per-side size the normal approximation is shaky; use the
#: permutation test instead.
SMALL_SAMPLE_N = 5

VERDICT_REGRESSION = "regression"
VERDICT_IMPROVEMENT = "improvement"
VERDICT_NEUTRAL = "neutral"
VERDICT_INSUFFICIENT = "insufficient-data"

#: First-class SECONDARY metrics the gate verdicts beside the primary
#: (benchreg follow-up (a) / step-anatomy round): each entry names a
#: result-row key, its direction sign, its minimum-effect floor and its
#: comparison scale. ``rel`` compares relative deltas (percent of
#: baseline); ``abs_pp`` compares fractions on an absolute
#: percentage-point scale — a comms_exposed_frac of 0.00 -> 0.05 is a
#: 5-point regression, not an undefined relative delta. All scalar-mode:
#: one value per run, noise floor learned from same-config registry
#: history (MIN_SCALAR_HISTORY applies, so sparse history reports
#: insufficient-data instead of minting verdicts).
SECONDARY_METRICS = (
    # (result key, higher_is_better, min effect, scale)
    ("mfu_pct", True, 2.0, "rel"),
    ("peak_hbm_gb", False, 5.0, "rel"),
    ("comms_exposed_frac", False, 2.0, "abs_pp"),
    # Scaling observatory: the 0-1 fraction of ideal per-chip throughput
    # vs the suite's smallest-geometry base, stamped onto clean rows by
    # analysis.scaling.stamp_results_dir before ingest. Absolute pp scale
    # like comms_exposed_frac (a 2 pp efficiency drop at ws=8 is a
    # regression even when the ws=8 absolute throughput sits inside its
    # own noise floor) — the arm slug names the geometry in the gate line.
    ("scaling_efficiency", True, 2.0, "abs_pp"),
    # Pipeline-arm bubble fraction (step-anatomy device idle — only
    # pipeline rows carry it, others skip via the both-rows-present
    # rule). Absolute pp scale like comms_exposed_frac: a schedule whose
    # bubble grew 2pp regressed even when wall-clock noise hides it —
    # the dynamic half of the schedule auditor's structural bubble
    # bound (docs/STATIC_ANALYSIS.md).
    ("bubble_frac", False, 2.0, "abs_pp"),
    # Memory-anatomy model drift (analysis/memory_anatomy.py):
    # |reference peak − analytic estimate| / analytic, where the
    # reference is the allocator's measured peak (or XLA's
    # buffer-assignment peak on backends without memory_stats). Lower is
    # better — a growing drift means utils/memory.py's analytic model is
    # decaying, which silently degrades the pre-flight OOM refusals and
    # the auto-remat resolver that trust it. Absolute pp scale (a
    # healthy drift can legitimately sit near 0); 5 pp floor because the
    # model's documented accuracy band is ±20% — the gate polices
    # DECAY, not the residual itself.
    ("hbm_model_drift_frac", False, 5.0, "abs_pp"),
    # Streaming-data-path input starvation (train/loop.py + data/
    # prefetch.py): the fraction of timed step wall the loop spent
    # starved for input. Only streaming (--data-path) rows carry it
    # (synthetic rows publish null, so the both-rows-present rule skips
    # them). Absolute pp scale like the other fractions — a healthy
    # stream legitimately sits at ~0, where a relative delta is
    # undefined; 2 pp of new input-boundedness is a regression even when
    # the wall-clock delta hides inside the throughput noise floor.
    ("data_stall_frac", False, 2.0, "abs_pp"),
)
#: Absolute-scale fallback noise floor (percentage points) below 3
#: same-config history runs.
DEFAULT_NOISE_FLOOR_PP = 1.0


# ---------------------------------------------------------------------------
# Telemetry extraction
# ---------------------------------------------------------------------------


def timed_windows(
    events: Sequence[Dict[str, Any]], *, mask_spikes: bool = False,
) -> List[Dict[str, Any]]:
    """The comparable sample: ``step_window`` events from the timed phase.

    Compile/warmup windows are excluded (their times measure XLA, not the
    step); a run that never reached the timed phase yields [] and the
    comparison degrades to scalar mode rather than comparing warmup noise.
    ``mask_spikes`` additionally drops windows the recorder flagged inside
    an open ``step_time_spike`` anomaly (see :func:`split_masked_windows`
    for the count — masking must never be silent).
    """
    kept, _ = split_masked_windows(events, mask_spikes=mask_spikes)
    return kept


def split_masked_windows(
    events: Sequence[Dict[str, Any]], *, mask_spikes: bool = True,
) -> tuple:
    """Timed windows split into (kept, spike-masked) lists.

    Window-level anomaly masking (benchreg follow-up (c)): a window that
    ran during an open recorder spike measures the stall, not the code —
    comparing it verdicts the incident. The masked windows are returned
    (not dropped on the floor) so every consumer can surface a
    ``masked_windows`` count beside its verdict.

    Sentinel rollbacks (self-healing round) mask the same way: a
    ``rollback`` event means every window in ``(to_step, from_step]`` was
    measured twice — once poisoned, once replaying over the restore — and
    neither copy is run-to-run jitter of the code under test. Both copies
    leave the comparison sample, mirroring the result row's
    replayed-steps exclusion.
    """
    from ..telemetry import spike_mask_intervals, step_in_spike

    events = list(events)
    intervals = spike_mask_intervals(events) if mask_spikes else []
    rollbacks = [
        (e.get("to_step"), e.get("from_step"))
        for e in events
        if e.get("event") == "rollback"
        and e.get("to_step") is not None and e.get("from_step") is not None
    ]

    def in_rollback(step):
        return step is not None and any(
            lo < step <= hi for lo, hi in rollbacks
        )

    kept: List[Dict[str, Any]] = []
    masked: List[Dict[str, Any]] = []
    for e in events:
        if e.get("event") != "step_window" or e.get("phase") != "timed":
            continue
        dt = e.get("window_mean_step_time_sec")
        if dt is None or dt <= 0:
            continue
        w = {
            "step": e.get("step"),
            "steps_in_window": e.get("steps_in_window", 1),
            "dt": float(dt),
            "loss": e.get("loss"),
        }
        if (
            (intervals and step_in_spike(e.get("step"), intervals))
            or in_rollback(e.get("step"))
        ):
            masked.append(w)
        else:
            kept.append(w)
    return kept, masked


def window_step_times(record: Dict[str, Any]) -> List[float]:
    return [w["dt"] for w in record.get("windows", []) if w.get("dt")]


def window_tokens_per_sec(record: Dict[str, Any]) -> List[float]:
    """Per-window throughput: tokens_per_step / window mean step time."""
    tps = record.get("tokens_per_step", 0) or 0
    if tps <= 0:
        return []
    return [tps / w["dt"] for w in record.get("windows", []) if w.get("dt")]


# ---------------------------------------------------------------------------
# Core statistics (all seeded / closed-form)
# ---------------------------------------------------------------------------


def _phi(z: float) -> float:
    """Standard normal CDF via erf (no scipy dependency)."""
    return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))


def mann_whitney_p(a: Sequence[float], b: Sequence[float]) -> float:
    """Two-sided Mann-Whitney U p-value (normal approx, tie-corrected).

    Identical samples (zero rank variance) return p=1.0 — indistinguishable
    by construction.
    """
    n1, n2 = len(a), len(b)
    if n1 == 0 or n2 == 0:
        return 1.0
    pooled = sorted([(v, 0) for v in a] + [(v, 1) for v in b])
    # Average ranks over ties.
    ranks = [0.0] * len(pooled)
    i = 0
    while i < len(pooled):
        j = i
        while j < len(pooled) and pooled[j][0] == pooled[i][0]:
            j += 1
        avg_rank = (i + j + 1) / 2.0  # ranks are 1-based
        for k in range(i, j):
            ranks[k] = avg_rank
        i = j
    r1 = sum(r for r, (_, grp) in zip(ranks, pooled) if grp == 0)
    u1 = r1 - n1 * (n1 + 1) / 2.0
    mu = n1 * n2 / 2.0
    n = n1 + n2
    # Tie-corrected variance.
    tie_term = 0.0
    i = 0
    while i < len(pooled):
        j = i
        while j < len(pooled) and pooled[j][0] == pooled[i][0]:
            j += 1
        t = j - i
        tie_term += t**3 - t
        i = j
    var = n1 * n2 / 12.0 * ((n + 1) - tie_term / (n * (n - 1)))
    if var <= 0:
        return 1.0
    z = (u1 - mu - math.copysign(0.5, u1 - mu)) / math.sqrt(var)
    return max(min(2.0 * (1.0 - _phi(abs(z))), 1.0), 0.0)


def permutation_p(
    a: Sequence[float], b: Sequence[float],
    n_perm: int = PERMUTATION_N, seed: int = BOOTSTRAP_SEED,
) -> float:
    """Two-sided permutation test of the mean difference (seeded)."""
    n1, n2 = len(a), len(b)
    if n1 == 0 or n2 == 0:
        return 1.0
    pooled = np.asarray(list(a) + list(b), dtype=float)
    observed = abs(float(np.mean(pooled[:n1]) - np.mean(pooled[n1:])))
    rng = np.random.default_rng(seed)
    hits = 0
    for _ in range(n_perm):
        perm = rng.permutation(pooled)
        if abs(float(np.mean(perm[:n1]) - np.mean(perm[n1:]))) >= observed - 1e-15:
            hits += 1
    # +1 smoothing: a permutation p-value of exactly 0 overstates evidence.
    return (hits + 1) / (n_perm + 1)


def significance_p(a: Sequence[float], b: Sequence[float]) -> float:
    """Rank test at window sizes; permutation test for tiny samples."""
    if min(len(a), len(b)) < SMALL_SAMPLE_N:
        return permutation_p(a, b)
    return mann_whitney_p(a, b)


def bootstrap_mean_ci(
    samples: Sequence[float], *, confidence: float = 0.95,
    n_boot: int = BOOTSTRAP_N, seed: int = BOOTSTRAP_SEED,
) -> tuple:
    """Seeded percentile-bootstrap CI on the mean of one sample."""
    x = np.asarray(samples, dtype=float)
    if x.size == 0:
        return (float("nan"), float("nan"))
    rng = np.random.default_rng(seed)
    means = np.mean(
        x[rng.integers(0, x.size, size=(n_boot, x.size))], axis=1
    )
    lo = (1.0 - confidence) / 2.0
    return (float(np.quantile(means, lo)),
            float(np.quantile(means, 1.0 - lo)))


def bootstrap_delta_ci_pct(
    base: Sequence[float], cand: Sequence[float], *,
    confidence: float = 0.95, n_boot: int = BOOTSTRAP_N,
    seed: int = BOOTSTRAP_SEED,
) -> tuple:
    """Seeded CI on the relative delta of means, in percent of baseline."""
    a = np.asarray(base, dtype=float)
    b = np.asarray(cand, dtype=float)
    if a.size == 0 or b.size == 0 or float(np.mean(a)) == 0.0:
        return (float("nan"), float("nan"))
    rng = np.random.default_rng(seed)
    am = np.mean(a[rng.integers(0, a.size, size=(n_boot, a.size))], axis=1)
    bm = np.mean(b[rng.integers(0, b.size, size=(n_boot, b.size))], axis=1)
    deltas = 100.0 * (bm - am) / am
    lo = (1.0 - confidence) / 2.0
    return (float(np.quantile(deltas, lo)),
            float(np.quantile(deltas, 1.0 - lo)))


def noise_floor_pct(values: Sequence[float]) -> float:
    """Run-to-run noise estimate from repeated same-arm measurements.

    2x the coefficient of variation (~95% band under roughly-normal
    noise); falls back to DEFAULT_NOISE_FLOOR_PCT below 3 samples.
    """
    x = np.asarray(values, dtype=float)
    x = x[np.isfinite(x)]
    if x.size < 3 or float(np.mean(x)) == 0.0:
        return DEFAULT_NOISE_FLOOR_PCT
    cv = float(np.std(x) / abs(np.mean(x)))
    return max(200.0 * cv, 0.0)


def noise_floor_abs(values: Sequence[float]) -> float:
    """Absolute-scale noise floor: 2x the history's standard deviation.

    The percentage-point analogue of :func:`noise_floor_pct` for metrics
    whose baseline can legitimately be ~0 (comms_exposed_frac) — a
    relative CV there divides by nothing. Falls back to
    DEFAULT_NOISE_FLOOR_PP below 3 samples.
    """
    x = np.asarray(values, dtype=float)
    x = x[np.isfinite(x)]
    if x.size < 3:
        return DEFAULT_NOISE_FLOOR_PP
    return max(2.0 * float(np.std(x)), 0.0)


# ---------------------------------------------------------------------------
# Verdicts
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MetricComparison:
    """One metric's baseline-vs-candidate outcome, with its evidence."""

    metric: str
    higher_is_better: bool
    mode: str  # 'windows' | 'scalar'
    n_base: int
    n_cand: int
    base_mean: float
    cand_mean: float
    delta_pct: float
    ci_lo_pct: float
    ci_hi_pct: float
    p_value: Optional[float]
    threshold_pct: float
    verdict: str
    note: str = ""
    #: Unit of delta/CI/threshold: "%" (relative to baseline) or "pp"
    #: (absolute percentage points — the abs_pp secondary metrics, whose
    #: baseline can legitimately be 0 so a relative delta is undefined).
    unit: str = "%"

    def summary(self) -> str:
        u = self.unit
        ci = (f"CI95=[{self.ci_lo_pct:+.2f}{u}, {self.ci_hi_pct:+.2f}{u}]"
              if math.isfinite(self.ci_lo_pct) else "CI95=[n/a]")
        p = f" p={self.p_value:.4g}" if self.p_value is not None else ""
        return (
            f"metric={self.metric} delta={self.delta_pct:+.2f}{u} {ci}{p} "
            f"threshold={self.threshold_pct:.2f}{u} verdict={self.verdict}"
            + (f" ({self.note})" if self.note else "")
        )


def _classify(
    delta_pct: float, ci_lo: float, ci_hi: float, p: Optional[float],
    *, higher_is_better: bool, threshold_pct: float, alpha: float,
) -> str:
    """Shared verdict rule (see module docstring for the semantics)."""
    if higher_is_better:
        worse = delta_pct <= -threshold_pct
        better = delta_pct >= threshold_pct
        ci_excludes_zero_worse = math.isfinite(ci_hi) and ci_hi < 0.0
        ci_excludes_zero_better = math.isfinite(ci_lo) and ci_lo > 0.0
    else:
        worse = delta_pct >= threshold_pct
        better = delta_pct <= -threshold_pct
        ci_excludes_zero_worse = math.isfinite(ci_lo) and ci_lo > 0.0
        ci_excludes_zero_better = math.isfinite(ci_hi) and ci_hi < 0.0
    significant = p is None or p < alpha
    if worse and significant and ci_excludes_zero_worse:
        return VERDICT_REGRESSION
    if better and significant and ci_excludes_zero_better:
        return VERDICT_IMPROVEMENT
    return VERDICT_NEUTRAL


def compare_distributions(
    base: Sequence[float], cand: Sequence[float], *,
    metric: str, higher_is_better: bool,
    min_effect_pct: float = DEFAULT_MIN_EFFECT_PCT,
    alpha: float = DEFAULT_ALPHA,
    noise_pct: float = 0.0,
) -> MetricComparison:
    """Window-distribution comparison (the preferred mode)."""
    threshold = max(min_effect_pct, noise_pct)
    n1, n2 = len(base), len(cand)
    if n1 < MIN_WINDOWS or n2 < MIN_WINDOWS:
        return MetricComparison(
            metric=metric, higher_is_better=higher_is_better,
            mode="windows", n_base=n1, n_cand=n2,
            base_mean=float(np.mean(base)) if n1 else float("nan"),
            cand_mean=float(np.mean(cand)) if n2 else float("nan"),
            delta_pct=float("nan"), ci_lo_pct=float("nan"),
            ci_hi_pct=float("nan"), p_value=None,
            threshold_pct=threshold, verdict=VERDICT_INSUFFICIENT,
            note=f"need >= {MIN_WINDOWS} timed windows per side "
                 f"(have {n1} vs {n2})",
        )
    bm, cm = float(np.mean(base)), float(np.mean(cand))
    delta_pct = 100.0 * (cm - bm) / bm if bm else float("nan")
    ci_lo, ci_hi = bootstrap_delta_ci_pct(base, cand)
    p = significance_p(base, cand)
    verdict = _classify(
        delta_pct, ci_lo, ci_hi, p, higher_is_better=higher_is_better,
        threshold_pct=threshold, alpha=alpha,
    )
    return MetricComparison(
        metric=metric, higher_is_better=higher_is_better, mode="windows",
        n_base=n1, n_cand=n2, base_mean=bm, cand_mean=cm,
        delta_pct=delta_pct, ci_lo_pct=ci_lo, ci_hi_pct=ci_hi, p_value=p,
        threshold_pct=threshold, verdict=verdict,
    )


def compare_scalars(
    base_value: float, cand_value: float, *,
    metric: str, higher_is_better: bool,
    history: Sequence[float] = (),
    min_effect_pct: float = DEFAULT_MIN_EFFECT_PCT,
    absolute: bool = False,
) -> MetricComparison:
    """Scalar-vs-history comparison for runs without telemetry windows.

    One number per side means no within-run distribution, so the
    registry's same-arm history supplies the spread: the verdict band is
    the noise floor around the baseline, and the reported interval is
    the delta +/- that floor. No p-value is claimed — there is no test
    statistic to compute from two scalars.

    ``absolute=True`` compares on the values' own (pre-scaled) absolute
    scale instead of percent-of-baseline: delta/CI/threshold are then all
    in the same units as the inputs (the secondary-metric ``abs_pp``
    entries pre-scale fractions to percentage points), and a zero
    baseline is a legal value rather than a division hazard.
    """
    history = [v for v in history if v is not None]
    noise = noise_floor_abs(history) if absolute else noise_floor_pct(history)
    threshold = max(min_effect_pct, noise)
    unit = "pp" if absolute else "%"
    missing = base_value is None or cand_value is None
    if not absolute and not missing and not base_value:
        missing = True  # relative scale needs a nonzero baseline
    if missing:
        return MetricComparison(
            metric=metric, higher_is_better=higher_is_better, mode="scalar",
            n_base=1 if base_value is not None else 0,
            n_cand=1 if cand_value is not None else 0,
            base_mean=float(base_value if base_value is not None else "nan"),
            cand_mean=float(cand_value if cand_value is not None else "nan"),
            delta_pct=float("nan"), ci_lo_pct=float("nan"),
            ci_hi_pct=float("nan"), p_value=None, threshold_pct=threshold,
            verdict=VERDICT_INSUFFICIENT, note="missing metric value",
            unit=unit,
        )
    if absolute:
        delta_pct = float(cand_value) - float(base_value)
    else:
        delta_pct = 100.0 * (cand_value - base_value) / base_value
    ci_lo, ci_hi = delta_pct - noise, delta_pct + noise
    if len(history) < MIN_SCALAR_HISTORY:
        # The delta is still reported (trend/triage value) but an
        # unlearned noise floor must not verdict (see MIN_SCALAR_HISTORY).
        verdict = VERDICT_INSUFFICIENT
    else:
        verdict = _classify(
            delta_pct, ci_lo, ci_hi, None, higher_is_better=higher_is_better,
            threshold_pct=threshold, alpha=DEFAULT_ALPHA,
        )
    return MetricComparison(
        metric=metric, higher_is_better=higher_is_better, mode="scalar",
        n_base=1, n_cand=1, base_mean=float(base_value),
        cand_mean=float(cand_value), delta_pct=delta_pct,
        ci_lo_pct=ci_lo, ci_hi_pct=ci_hi, p_value=None,
        threshold_pct=threshold, verdict=verdict, unit=unit,
        note=(
            f"scalar mode, noise floor {noise:.2f}{unit} "
            f"from {len(history)} history runs"
            + (" (absolute pp scale)" if absolute else "")
            + ("" if len(history) >= MIN_SCALAR_HISTORY else
               f" — need >= {MIN_SCALAR_HISTORY} for a verdict")
        ),
    )


def secondary_comparisons(
    base_rec: Dict[str, Any], cand_rec: Dict[str, Any], *,
    secondary_history: Optional[Dict[str, Sequence[float]]] = None,
) -> List[MetricComparison]:
    """Scalar comparisons for every SECONDARY metric both rows carry.

    Benchreg follow-up (a): MFU, peak HBM and the step-anatomy
    comms_exposed_frac verdict beside the primary throughput metric, each
    with its own direction sign, minimum effect and (per-metric,
    same-config) noise-floor history. Metrics absent from either result
    row are skipped — old records stay comparable.
    """
    out: List[MetricComparison] = []
    br = base_rec.get("result") or {}
    cr = cand_rec.get("result") or {}
    hist = secondary_history or {}
    for key, hib, min_eff, scale in SECONDARY_METRICS:
        bv, cv = br.get(key), cr.get(key)
        if bv is None or cv is None:
            continue
        values = [v for v in hist.get(key, ()) if v is not None]
        if scale == "abs_pp":
            # Fractions verdict on an absolute percentage-point scale.
            bv, cv = float(bv) * 100.0, float(cv) * 100.0
            values = [float(v) * 100.0 for v in values]
        out.append(compare_scalars(
            bv, cv, metric=key, higher_is_better=hib, history=values,
            min_effect_pct=min_eff, absolute=(scale == "abs_pp"),
        ))
    return out


def compare_records(
    base_rec: Dict[str, Any], cand_rec: Dict[str, Any], *,
    min_effect_pct: float = DEFAULT_MIN_EFFECT_PCT,
    alpha: float = DEFAULT_ALPHA,
    history: Sequence[float] = (),
    secondary_history: Optional[Dict[str, Sequence[float]]] = None,
) -> List[MetricComparison]:
    """Compare two registry records; first comparison is the gate metric.

    Window mode when both records carry enough timed windows (primary:
    per-window tokens/sec; secondary: step time); scalar mode against
    registry history otherwise. Either way the SECONDARY metric
    comparisons (MFU / peak HBM / comms_exposed_frac — see
    :data:`SECONDARY_METRICS`) are appended after the primary ones.
    Partial candidates/baselines are the caller's (``regress.compare``)
    responsibility to refuse — this function compares whatever it is
    handed.
    """
    out: List[MetricComparison] = []
    b_tps = window_tokens_per_sec(base_rec)
    c_tps = window_tokens_per_sec(cand_rec)
    noise = noise_floor_pct(history) if history else 0.0
    if len(b_tps) >= MIN_WINDOWS and len(c_tps) >= MIN_WINDOWS:
        out.append(compare_distributions(
            b_tps, c_tps, metric="tokens_per_sec", higher_is_better=True,
            min_effect_pct=min_effect_pct, alpha=alpha, noise_pct=noise,
        ))
        out.append(compare_distributions(
            window_step_times(base_rec), window_step_times(cand_rec),
            metric="window_mean_step_time_sec", higher_is_better=False,
            min_effect_pct=min_effect_pct, alpha=alpha, noise_pct=noise,
        ))
    else:
        bm = (base_rec.get("metric") or {})
        cm = (cand_rec.get("metric") or {})
        name = cm.get("name") or bm.get("name") or "metric"
        out.append(compare_scalars(
            bm.get("value"), cm.get("value"), metric=name,
            higher_is_better=bool(cm.get("higher_is_better", True)),
            history=history, min_effect_pct=min_effect_pct,
        ))
    out.extend(secondary_comparisons(
        base_rec, cand_rec, secondary_history=secondary_history,
    ))
    # Window-level anomaly masking is never silent: the counts ride the
    # primary comparison's note (and so its summary()/gate line).
    masked_b = int(base_rec.get("masked_windows", 0) or 0)
    masked_c = int(cand_rec.get("masked_windows", 0) or 0)
    if out and (masked_b or masked_c):
        extra = f"masked_windows={masked_b}/{masked_c}"
        out[0].note = f"{out[0].note}, {extra}" if out[0].note else extra
    return out


# ---------------------------------------------------------------------------
# Telemetry-file comparison (analysis.telemetry_report --compare)
# ---------------------------------------------------------------------------


def compare_telemetry(
    events_a: Sequence[Dict[str, Any]], events_b: Sequence[Dict[str, Any]], *,
    min_effect_pct: float = DEFAULT_MIN_EFFECT_PCT,
    alpha: float = DEFAULT_ALPHA,
) -> Dict[str, Any]:
    """Two telemetry JSONL event streams -> per-phase + per-window deltas.

    The ROADMAP's ``telemetry_report --compare A B`` regression-triage
    mode: phase-time attribution deltas (where did the extra wall time
    go) plus the window-distribution comparisons on the timed phase
    (did the step itself get slower, with what confidence).
    """
    from ..analysis.telemetry_report import build_timeline
    from ..telemetry import PHASES

    tla, tlb = build_timeline(list(events_a)), build_timeline(list(events_b))
    phases: List[Dict[str, Any]] = []
    present = set(tla["phase_times"]) | set(tlb["phase_times"])
    ordered = [ph for ph in PHASES if ph in present] + sorted(
        present - set(PHASES)
    )
    for phase in ordered:
        a = tla["phase_times"].get(phase)
        b = tlb["phase_times"].get(phase)
        phases.append({
            "phase": phase, "a_sec": a, "b_sec": b,
            "delta_sec": (b - a) if (a is not None and b is not None) else None,
            "delta_pct": (100.0 * (b - a) / a)
            if (a and b is not None) else None,
        })
    wa, masked_a = split_masked_windows(events_a)
    wb, masked_b = split_masked_windows(events_b)
    meta_a, meta_b = tla["meta"], tlb["meta"]
    comparisons: List[MetricComparison] = [compare_distributions(
        [w["dt"] for w in wa], [w["dt"] for w in wb],
        metric="window_mean_step_time_sec", higher_is_better=False,
        min_effect_pct=min_effect_pct, alpha=alpha,
    )]
    tps_a = int(meta_a.get("tokens_per_step", 0) or 0)
    tps_b = int(meta_b.get("tokens_per_step", 0) or 0)
    if tps_a > 0 and tps_b > 0:
        comparisons.insert(0, compare_distributions(
            [tps_a / w["dt"] for w in wa], [tps_b / w["dt"] for w in wb],
            metric="tokens_per_sec", higher_is_better=True,
            min_effect_pct=min_effect_pct, alpha=alpha,
        ))
    if masked_a or masked_b:
        # The masking rides the PRIMARY comparison's note (and so its
        # summary line / the verdict line) — never silent.
        extra = f"masked_windows={len(masked_a)}/{len(masked_b)}"
        comparisons[0].note = (
            f"{comparisons[0].note}, {extra}" if comparisons[0].note
            else extra
        )
    return {
        "a": {"arm": meta_a.get("arm"), "wall": tla["wall"],
              "n_timed_windows": len(wa),
              "masked_windows": len(masked_a)},
        "b": {"arm": meta_b.get("arm"), "wall": tlb["wall"],
              "n_timed_windows": len(wb),
              "masked_windows": len(masked_b)},
        "phases": phases,
        "comparisons": comparisons,
    }
