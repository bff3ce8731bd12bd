"""Numerics sentinel: detect -> roll back -> replay, without losing the run.

Port of ``distributed_llm_training_benchmark_framework_tpu/faults/sentinel.py``
(no device work, so a plain copy: the same guards, constants, events and
rollback ledger). The flight recorder *screens* a NaN loss, but the run
itself either dies or trains on garbage. The sentinel closes the loop in
process:

- **Guards** (host floats, judged only at sync-window boundaries, where the
  device is already fenced):

  * a non-finite loss, or one that jumps past (or collapses below) the
    rolling-median envelope;
  * a non-finite or exploding **global grad-norm**: with the sentinel armed
    the train step returns the fp32 norm of the step's averaged gradients
    as a 0-d device tensor (``train.step.TrainStep``; the clip's own norm
    where the gradients are fp32), read at the boundary with the loss;
  * a per-N-steps **parameter checksum** (the global L2 norm) for silent
    data corruption: parameters move slowly, so a flipped exponent moves
    the norm by orders of magnitude (or to inf/NaN) between two checksums.

- **On trip** the run does not die: the loop rolls back in process to the
  last *validated* checkpoint (a digest-verified restore, or the in-memory
  snapshot of a run with no checkpoint cadence), reseeds the synthetic
  input past the poisoned region and replays. ``MAX_ROLLBACKS`` bounds the
  loop: a persistent numerics failure aborts loudly.

- **Accounting**: every trip emits a ``sentinel_trip`` telemetry event and
  every rollback a ``rollback`` event; the result row carries
  ``n_rollbacks`` / ``rollback_steps_replayed``; replayed windows are kept
  out of the timed distributions.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

#: A boundary loss must stay under ``median + LOSS_ENVELOPE_NATS`` of the
#: rolling window (and under FACTOR x median) to pass. Both conditions:
#: early training legitimately wobbles whole nats while the median is
#: still high, and tiny late-run medians would make a pure factor twitchy.
LOSS_ENVELOPE_NATS = 2.0
LOSS_SPIKE_FACTOR = 2.0
#: Grad-norm guard: trip when the step's global grad-norm exceeds
#: FACTOR x the rolling median (gradient explosion), or is non-finite.
GRAD_SPIKE_FACTOR = 10.0
#: Param-checksum guard: trip when the parameter-tree L2 norm moves by
#: more than this fraction between consecutive checksums (params move at
#: ~lr per step; an SDC bit flip in an exponent moves them by orders of
#: magnitude), or is non-finite.
PARAM_NORM_JUMP_FRAC = 0.5
#: Minimum rolling-window history before the envelope guards judge — the
#: same warm-up posture as the telemetry spike screen.
MIN_HISTORY = 3
#: Rolling-window length for the loss / grad-norm medians.
WINDOW = 16
#: Rollbacks after which the sentinel stops healing and aborts the run
#: loudly — a trip that survives this many replays is a persistent bug
#: (or a poisoned checkpoint), not a transient.
MAX_ROLLBACKS = 3


def _median(vals: List[float]) -> float:
    return sorted(vals)[len(vals) // 2]


class SentinelTripped(RuntimeError):
    """The sentinel tripped but could not (or may no longer) roll back —
    no validated checkpoint behind the run, or MAX_ROLLBACKS exhausted.
    The harness maps it to a plain failure: the run is garbage and says
    so, rather than publishing it."""

    def __init__(self, kind: str, step: int, detail: str):
        self.kind = kind
        self.step = step
        super().__init__(
            f"numerics sentinel tripped ({kind}) at step {step} with no "
            f"rollback available: {detail}"
        )


class NumericsSentinel:
    """Boundary-cadence numerics guards + rollback accounting.

    The loop owns the actual rollback (it holds params/opt_state and the
    checkpointer); the sentinel owns detection and the honest ledger.
    All inputs are host floats the loop already synced — the sentinel
    itself performs no device work and no IO beyond recorder events.
    """

    def __init__(
        self,
        *,
        recorder=None,
        is_main: bool = True,
        max_rollbacks: int = MAX_ROLLBACKS,
        window: int = WINDOW,
    ):
        self.recorder = recorder
        self.is_main = is_main
        self.max_rollbacks = max_rollbacks
        self.window = window
        self._loss_hist: List[float] = []
        self._gnorm_hist: List[float] = []
        self._last_pnorm: Optional[float] = None
        #: The open trip ({kind, step, detail}) awaiting the loop's
        #: rollback decision, or None.
        self.trip: Optional[Dict[str, Any]] = None
        self.n_trips = 0
        self.n_rollbacks = 0
        self.rollback_steps_replayed = 0
        #: How many data-stream reseeds are in effect: the loop folds
        #: ``data_reseeds * total_steps`` into the step index it hands the
        #: train step, so replayed steps draw fresh batch rows and
        #: dropout keys instead of re-consuming the poisoned sequence.
        self.data_reseeds = 0

    # -- guards (sync-window boundaries only) -------------------------------

    def observe(
        self, step: int, loss: float, grad_norm: Optional[float] = None,
    ) -> Optional[Dict[str, Any]]:
        """Judge one synced step's loss (and grad-norm, when armed).

        Returns the trip dict when a guard fires (also stored on
        ``self.trip`` for the loop's boundary handler), else None. While
        a trip is open further observations are no-ops — the poisoned
        tail must not mint N events for one incident.
        """
        if self.trip is not None:
            return None
        if loss != loss or math.isinf(loss):
            return self._trip("nan_loss", step, "non-finite loss")
        if grad_norm is not None:
            if grad_norm != grad_norm or math.isinf(grad_norm):
                return self._trip(
                    "grad_explode", step, "non-finite global grad-norm"
                )
            if len(self._gnorm_hist) >= MIN_HISTORY:
                med = _median(self._gnorm_hist)
                if med > 0 and grad_norm > GRAD_SPIKE_FACTOR * med:
                    return self._trip(
                        "grad_explode", step,
                        f"global grad-norm {grad_norm:.4g} > "
                        f"{GRAD_SPIKE_FACTOR:g}x rolling median {med:.4g}",
                    )
        if len(self._loss_hist) >= MIN_HISTORY:
            med = _median(self._loss_hist)
            if (
                loss > med + LOSS_ENVELOPE_NATS
                and loss > LOSS_SPIKE_FACTOR * med
            ):
                return self._trip(
                    "loss_spike", step,
                    f"loss {loss:.4g} > rolling median {med:.4g} + "
                    f"{LOSS_ENVELOPE_NATS:g} nats",
                )
            # The envelope is two-sided: a COLLAPSE is the other poisoned
            # shape — saturated logits land on the gold token and the
            # loss free-falls to ~0 in one window (real descent moves
            # fractions of a nat per window, never whole nats).
            if (
                loss < med - LOSS_ENVELOPE_NATS
                and loss < med / LOSS_SPIKE_FACTOR
            ):
                return self._trip(
                    "loss_collapse", step,
                    f"loss {loss:.4g} < rolling median {med:.4g} - "
                    f"{LOSS_ENVELOPE_NATS:g} nats — saturated/corrupted "
                    "logits, not descent",
                )
        # Healthy values join the rolling windows (tripped ones never do —
        # one incident must not drag the median up and mask the next).
        self._loss_hist.append(loss)
        if grad_norm is not None:
            self._gnorm_hist.append(grad_norm)
        del self._loss_hist[: -self.window]
        del self._gnorm_hist[: -self.window]
        return None

    def observe_param_checksum(
        self, step: int, value: float,
    ) -> Optional[Dict[str, Any]]:
        """Judge one parameter-tree checksum (global L2 norm) sample."""
        if self.trip is not None:
            return None
        if value != value or math.isinf(value):
            return self._trip(
                "sdc", step, "non-finite parameter-tree checksum"
            )
        prev = self._last_pnorm
        if prev is not None and prev > 0:
            jump = abs(value - prev) / prev
            if jump > PARAM_NORM_JUMP_FRAC:
                return self._trip(
                    "sdc", step,
                    f"parameter-tree norm moved {100 * jump:.1f}% between "
                    f"checksums ({prev:.6g} -> {value:.6g}) — silent "
                    "corruption envelope is "
                    f"{100 * PARAM_NORM_JUMP_FRAC:.0f}%",
                )
        self._last_pnorm = value
        return None

    def _trip(self, kind: str, step: int, detail: str) -> Dict[str, Any]:
        self.n_trips += 1
        self.trip = {"kind": kind, "step": step, "detail": detail}
        if self.recorder is not None:
            try:
                self.recorder.note("sentinel_trip", **self.trip)
            except Exception:
                pass
        if self.is_main:
            print(f"SENTINEL: {kind} tripped at step {step} — {detail}",
                  flush=True)
        return self.trip

    # -- rollback ledger -----------------------------------------------------

    @property
    def rollback_allowed(self) -> bool:
        return self.n_rollbacks < self.max_rollbacks

    def note_rollback(self, *, from_step: int, to_step: int) -> None:
        """Record one executed rollback and clear the open trip.

        ``from_step`` is the boundary the trip was detected at;
        ``to_step`` the checkpoint step the loop restored. The steps in
        between get replayed — counted here, and excluded from the timed
        distributions by the loop.
        """
        replayed = max(from_step - to_step, 0)
        self.n_rollbacks += 1
        self.rollback_steps_replayed += replayed
        self.data_reseeds += 1
        # The poisoned tail's values never joined the histories, but the
        # checksum baseline may predate the restore point — reset it so
        # the restored (older) params are not themselves judged a jump.
        self._last_pnorm = None
        trip = self.trip or {}
        self.trip = None
        if self.recorder is not None:
            try:
                self.recorder.note(
                    "rollback",
                    from_step=from_step,
                    to_step=to_step,
                    steps_replayed=replayed,
                    n_rollbacks=self.n_rollbacks,
                    data_reseeds=self.data_reseeds,
                    trip_kind=trip.get("kind"),
                )
            except Exception:
                pass
        if self.is_main:
            print(
                f"SENTINEL: rolling back to validated checkpoint step "
                f"{to_step} (trip at {from_step}; {replayed} step(s) to "
                f"replay, reseeded data stream; rollback "
                f"#{self.n_rollbacks}/{self.max_rollbacks})",
                flush=True,
            )
