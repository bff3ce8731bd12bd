"""Deterministic fault injection for the chaos harness.

Port of ``distributed_llm_training_benchmark_framework_tpu/faults/injection.py``:
the same registry of kinds, the same ``--inject-fault`` grammar and errors,
and ``INJECT_FAULT`` as the fallback when no flag is given. Every armed
fault fires at an exact, reproducible point:

- the stepped kinds (``sigkill@N``, ``sigterm@N``, ``sigterm-rank@N:R``,
  ``hang@N[:SECS]``, ``stall-rank@N:R[:SECS]``) fire at the first
  sync-window boundary whose last completed step is >= N;
- ``nan-loss@N`` turns step N's loss into NaN as it is dispatched;
- ``torn-checkpoint`` fires after the first save that leaves a *previous*
  committed step behind it: it truncates one file of the newest step and
  SIGKILLs, so the resume must quarantine that step and fall back;
- ``enospc-on-save`` raises ``OSError(ENOSPC)`` from every save: the run
  must degrade (a warning and a telemetry event) and still finish.

``bitflip``, ``grad-explode`` and ``opt-moments`` (the numerics sentinel's
proof faults) and the ``data-*`` kinds (the streaming input path's) parse
here; ``ARMED_KINDS`` lists what this injector fires, and
``train.loop.run_benchmark`` refuses the others, naming the module each
waits for (``WAITS_FOR``). A fault announces itself with a
``fault_injected`` telemetry event before firing (the JSONL is
line-buffered, so even a SIGKILL's trail records what killed it).
"""

from __future__ import annotations

import dataclasses
import errno
import os
import signal
import time
from typing import Optional

#: kind -> one-line contract, the registry --inject-fault validates against.
FAULT_KINDS = {
    "sigkill": "SIGKILL self at the first sync boundary with step >= N "
               "(the honest crash: no handlers, no flushes)",
    "sigterm": "SIGTERM self at the first sync boundary with step >= N "
               "(exercises the preemption handler end to end)",
    "sigterm-rank": "sigterm-rank@N:R — SIGTERM self at the first sync "
                    "boundary with step >= N, but ONLY on rank R "
                    "(exercises the cross-rank preempt-soon broadcast: "
                    "every OTHER rank must learn of the preemption from "
                    "the process group's store flag, not a signal)",
    "nan-loss": "corrupt step N's loss to NaN (trips the recorder's "
                "anomaly screen; validate_results must reject the row)",
    "hang": "sleep at the first sync boundary with step >= N "
            "(hang@N:SECS overrides the default stall; exercises the "
            "in-process hang watchdog / the liveness probe)",
    "stall-rank": "stall-rank@N:R[:SECS] — sleep at the first sync "
                  "boundary with step >= N, but ONLY on rank R "
                  "(exercises the cross-rank hang broadcast: every OTHER "
                  "rank must learn of the stall from the process "
                  "group's store hang flag and join the coherent "
                  "EXIT_HUNG abort)",
    "bitflip": "bitflip@N — corrupt one element of one parameter leaf "
               "before step N dispatches (silent-data-corruption "
               "analogue; the numerics sentinel's checksum/grad guards "
               "must trip and roll back)",
    "grad-explode": "grad-explode@N — scale one parameter leaf by a large "
                    "factor before step N dispatches, so the step's "
                    "global grad-norm explodes (the sentinel's grad-norm "
                    "guard must trip and roll back)",
    "opt-moments": "opt-moments@N — collapse the optimizer's second-"
                   "moment (Adam nu) accumulators toward zero before "
                   "step N dispatches: step N's update explodes (m/"
                   "(sqrt(nu)+eps) with a vanishing denominator) while "
                   "step N's own loss/grads stay healthy, so step N+1's "
                   "global grad-norm spikes FIRST — the sentinel's "
                   "grad-norm guard must trip before the loss/checksum "
                   "guards and roll back",
    "torn-checkpoint": "tear the newest checkpoint after a save that has "
                       "a previous committed step, then SIGKILL (restore "
                       "must quarantine and fall back)",
    "enospc-on-save": "every checkpoint save raises OSError(ENOSPC); the "
                      "run must degrade and still finish",
    "data-stall": "data-stall@N[:SECS] — the streaming input source goes "
                  "silent before the batch for step N (default stall "
                  "3600 s): the prefetch producer sleeps, the timed loop "
                  "starves, and the run must classify reason=data_stall "
                  "(exit 78, retryable-with-resume) — NOT the watchdog's "
                  "hang. Requires --data-path",
    "data-corrupt-record": "data-corrupt-record@N — flip one byte of "
                           "global record N's payload as it is read "
                           "(emulated disk bit-rot; the files are never "
                           "mutated): the CRC check must catch it, the "
                           "slot heals by substitution, and the "
                           "records_skipped ledger + data_corrupt_record "
                           "telemetry event record the quarantine. "
                           "Requires --data-path",
    "data-slow-reader": "data-slow-reader@N:MS — every record read from "
                        "global record N onward takes MS extra "
                        "milliseconds (a degraded mount): the run must "
                        "COMPLETE with an honest, elevated "
                        "data_stall_frac — degrade, never die. Requires "
                        "--data-path",
    "data-missing-shard": "data-missing-shard@K — shard K is withheld "
                          "from discovery (a hole in the corpus): the "
                          "stream must REFUSE loudly naming the shard "
                          "before any device work — training on a "
                          "silently truncated corpus is the failure this "
                          "proves impossible. Requires --data-path",
}

#: Kinds that take a mandatory ``@N`` step (for the data kinds, N is a
#: global record index / shard index rather than an optimizer step — the
#: same "a fault without a firing point is not reproducible" rule).
STEPPED_KINDS = frozenset(
    {"sigkill", "sigterm", "sigterm-rank", "nan-loss", "hang",
     "stall-rank", "bitflip", "grad-explode", "opt-moments",
     "data-stall", "data-corrupt-record", "data-slow-reader",
     "data-missing-shard"}
)

#: Kinds whose ``@N:R`` suffix names a target rank.
RANKED_KINDS = frozenset({"sigterm-rank", "stall-rank"})

#: Data-path kinds (fire inside data/stream.py + data/prefetch.py via the
#: injector's data_* hooks; require --data-path to have any consumer).
DATA_KINDS = frozenset(
    {"data-stall", "data-corrupt-record", "data-slow-reader",
     "data-missing-shard"}
)

#: Default stall for ``hang`` when the spec carries no ``:SECS``. Long
#: enough that any sane per-run timeout (or the k8s liveness probe) fires
#: first; the chaos suite passes a short override.
HANG_DEFAULT_SEC = 3600.0


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One parsed ``--inject-fault`` value."""

    kind: str
    step: Optional[int] = None
    hang_sec: Optional[float] = None
    # sigterm-rank@N:R — the one rank that receives the signal. Every rank
    # parses the same spec (the suite passes one value to every worker);
    # the injector compares against its own rank at fire time.
    rank: Optional[int] = None
    # data-slow-reader@N:MS — per-record extra read latency in
    # milliseconds (its own field so the spec string round-trips in the
    # unit the operator wrote; hang_sec stays seconds).
    delay_ms: Optional[float] = None

    def __str__(self) -> str:
        s = self.kind
        if self.step is not None:
            s += f"@{self.step}"
        if self.rank is not None:
            # Ranked grammar: KIND@N:R[:SECS] — the rank rides first.
            s += f":{self.rank}"
        if self.hang_sec is not None:
            s += f":{self.hang_sec:g}"
        if self.delay_ms is not None:
            s += f":{self.delay_ms:g}"
        return s


def parse_fault_spec(spec: Optional[str]) -> Optional[FaultSpec]:
    """``"sigkill@10"`` -> FaultSpec; None/empty -> None; junk raises.

    Grammar: ``KIND`` | ``KIND@STEP`` | ``hang@STEP:SECS`` |
    ``sigterm-rank@STEP:RANK`` | ``stall-rank@STEP:RANK[:SECS]``.
    Stepped kinds *require* the step (a fault with no defined firing
    point would not be reproducible) — the ranked kinds additionally
    require the target rank; the save-path kinds refuse one (they fire on
    save events, not steps).
    """
    if not spec:
        return None
    spec = spec.strip()
    kind, _, rest = spec.partition("@")
    if kind not in FAULT_KINDS:
        raise ValueError(
            f"unknown fault kind {kind!r} (expected one of "
            f"{sorted(FAULT_KINDS)})"
        )
    if kind in STEPPED_KINDS:
        if not rest:
            raise ValueError(
                f"fault {kind!r} needs an explicit step: {kind}@N "
                "(a fault without a firing step is not reproducible)"
            )
        step_str, _, suffix = rest.partition(":")
        if suffix and kind not in (
            "hang", "data-stall", "data-slow-reader", *RANKED_KINDS
        ):
            raise ValueError(
                f"only 'hang', 'data-stall', 'data-slow-reader' and the "
                f"ranked kinds ({sorted(RANKED_KINDS)}) take a suffix, "
                f"got {spec!r}"
            )
        if kind in RANKED_KINDS and not suffix:
            raise ValueError(
                f"{kind} needs a target rank: {kind}@N:R (without one the "
                f"fault is rankless — which rank it hits is the whole "
                "point of the spec)"
            )
        if kind == "data-slow-reader" and not suffix:
            raise ValueError(
                f"data-slow-reader needs a per-record latency: "
                f"data-slow-reader@N:MS (without one the degradation it "
                f"injects is undefined), got {spec!r}"
            )
        try:
            step = int(step_str)
        except ValueError:
            raise ValueError(f"fault step must be an integer, got {spec!r}")
        if step < 0:
            raise ValueError(f"fault step must be >= 0, got {spec!r}")
        hang_sec = None
        rank = None
        delay_ms = None
        if suffix and kind == "data-slow-reader":
            try:
                delay_ms = float(suffix)
            except ValueError:
                raise ValueError(
                    f"data-slow-reader latency must be a number of "
                    f"milliseconds, got {spec!r}"
                )
            if delay_ms <= 0:
                raise ValueError(
                    f"data-slow-reader latency must be > 0, got {spec!r}"
                )
            return FaultSpec(kind=kind, step=step, delay_ms=delay_ms)
        if suffix and kind in RANKED_KINDS:
            rank_str, _, secs_str = suffix.partition(":")
            if secs_str and kind != "stall-rank":
                raise ValueError(
                    f"only stall-rank takes a duration suffix, got {spec!r}"
                )
            try:
                rank = int(rank_str)
            except ValueError:
                raise ValueError(
                    f"{kind} target must be an integer rank, got {spec!r}"
                )
            if rank < 0:
                raise ValueError(f"fault rank must be >= 0, got {spec!r}")
            if secs_str:
                try:
                    hang_sec = float(secs_str)
                except ValueError:
                    raise ValueError(
                        f"stall duration must be a number, got {spec!r}"
                    )
                if hang_sec <= 0:
                    raise ValueError(
                        f"stall duration must be > 0, got {spec!r}"
                    )
        elif suffix:
            try:
                hang_sec = float(suffix)
            except ValueError:
                raise ValueError(
                    f"hang duration must be a number, got {spec!r}"
                )
            if hang_sec <= 0:
                raise ValueError(f"hang duration must be > 0, got {spec!r}")
        return FaultSpec(kind=kind, step=step, hang_sec=hang_sec, rank=rank)
    if rest:
        raise ValueError(
            f"fault {kind!r} fires on checkpoint saves and takes no @step "
            f"(got {spec!r})"
        )
    return FaultSpec(kind=kind)



#: The kinds this injector fires.
ARMED_KINDS = frozenset({"sigkill", "sigterm", "sigterm-rank", "nan-loss", "hang", "stall-rank",
                         "torn-checkpoint", "enospc-on-save"})

#: The parsed kinds that have no consumer in the port yet -> what they wait for.
WAITS_FOR = {
    **{k: "faults/sentinel.py (the numerics sentinel and its rollback)"
       for k in ("bitflip", "grad-explode", "opt-moments")},
    **{k: "data/stream.py and data/prefetch.py (the streaming input path, --data-path)"
       for k in DATA_KINDS},
}


def _tear_newest_file(step_dir: str) -> Optional[str]:
    """Truncate the first (sorted) non-empty file under ``step_dir``; the torn
    path, or None when nothing could be torn. A deterministic pick, so the
    torn artifact is the same on every run."""
    candidates = []
    for dirpath, _dirnames, filenames in os.walk(step_dir):
        for fn in sorted(filenames):
            path = os.path.join(dirpath, fn)
            try:
                if os.path.getsize(path) > 0:
                    candidates.append(path)
            except OSError:
                continue
    if not candidates:
        return None
    victim = sorted(candidates)[0]
    size = os.path.getsize(victim)
    with open(victim, "r+b") as f:
        f.truncate(max(size // 2, 1) - 1 if size > 1 else 0)
    return victim


class FaultInjector:
    """Arms one :class:`FaultSpec` against the train loop's boundaries. Call
    sites, all at device-fenced points (the injector adds no sync):
    :meth:`at_boundary` at the end of ``sync_window``, :meth:`corrupt_loss`
    on each dispatched loss, :meth:`maybe_fail_save` before a save and
    :meth:`after_save` after one. Inert without a spec."""

    def __init__(self, spec: Optional[FaultSpec] = None, recorder=None, is_main: bool = True,
                 rank: int = 0):
        self.spec = spec
        self.recorder = recorder
        self.is_main = is_main
        self.rank = rank
        self.fired = False

    def _announce(self, detail: str) -> None:
        if self.recorder is not None:
            try:
                self.recorder.note("fault_injected", fault=str(self.spec), detail=detail)
            except Exception:
                pass
        if self.is_main:
            print(f"CHAOS: injecting fault {self.spec} — {detail}", flush=True)

    def at_boundary(self, last_step: int) -> None:
        """Fire sigkill / sigterm / hang / stall at the first boundary past N."""
        if (self.spec is None or self.fired
                or self.spec.kind not in ("sigkill", "sigterm", "sigterm-rank", "hang",
                                          "stall-rank")
                or last_step < (self.spec.step or 0)):
            return
        if self.spec.kind in RANKED_KINDS and self.rank != (self.spec.rank or 0):
            # Not this rank's fault: it must learn of the preemption or the
            # hang from the store's flags, which is what the spec proves.
            return
        self.fired = True
        kind = self.spec.kind
        if kind in ("sigkill", "sigterm", "sigterm-rank"):
            sig = signal.SIGKILL if kind == "sigkill" else signal.SIGTERM
            who = f" (rank {self.rank})" if kind == "sigterm-rank" else ""
            self._announce(f"{sig.name}{who} at sync boundary, step {last_step}")
            os.kill(os.getpid(), sig)
        else:
            secs = self.spec.hang_sec or HANG_DEFAULT_SEC
            what = (f"stall (rank {self.rank}, {secs:g}s)" if kind == "stall-rank"
                    else f"hang ({secs:g}s stall)")
            self._announce(f"{what} at sync boundary, step {last_step}")
            time.sleep(secs)

    def corrupt_loss(self, step: int, loss):
        """NaN exactly step N's loss for ``nan-loss@N`` (else passthrough)."""
        if (self.spec is None or self.fired or self.spec.kind != "nan-loss"
                or step != self.spec.step):
            return loss
        self.fired = True
        self._announce(f"NaN loss injected at step {step}")
        return loss * float("nan")

    def maybe_fail_save(self) -> None:
        """Raise ENOSPC from the save path for ``enospc-on-save``."""
        if self.spec is None or self.spec.kind != "enospc-on-save":
            return
        self._announce("OSError(ENOSPC) raised from checkpoint save")
        raise OSError(errno.ENOSPC, "No space left on device (injected)")

    def after_save(self, ckpt, step: int) -> None:
        """Tear the newest checkpoint and SIGKILL for ``torn-checkpoint``, once
        a committed previous step exists to fall back to."""
        if self.spec is None or self.fired or self.spec.kind != "torn-checkpoint":
            return
        steps = ckpt.all_steps()
        if len(steps) < 2:
            return
        self.fired = True
        torn = _tear_newest_file(ckpt.step_dir(max(steps)))
        self._announce(f"tore checkpoint step {max(steps)} ({torn}); SIGKILL")
        os.kill(os.getpid(), signal.SIGKILL)
