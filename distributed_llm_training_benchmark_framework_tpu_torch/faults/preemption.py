"""Preemption-safe shutdown: SIGTERM -> flag -> emergency checkpoint.

Port of ``distributed_llm_training_benchmark_framework_tpu/faults/preemption.py``.
A supervisor delivers SIGTERM, waits its grace period, then SIGKILLs. The
loop cannot act on the signal inside a dispatched step, and the handler
must do nothing but set a flag (it can interrupt any bytecode, the
checkpoint's commit included). So:

1. :class:`PreemptionGuard` installs a flag-only SIGTERM handler outside
   the timed loop;
2. the loop polls it at sync-window boundaries (device fenced, state
   coherent);
3. on a set flag it saves an emergency checkpoint, records ``run_aborted
   reason=preempted`` and a final heartbeat, and raises :class:`Preempted`;
4. the harness maps :class:`Preempted` to :data:`EXIT_PREEMPTED`, the code
   the retrying orchestration resumes on.

Across ranks the flag travels over the process group's TCP store
(``runtime.distributed.publish_preempt_flag`` / ``agree_preempt_step``),
never over a collective: any rank's SIGTERM gives one coherent stop step.
"""

from __future__ import annotations

import signal
from typing import Optional

from ..runtime import distributed as dist_rt

from ..exit_codes import EXIT_NOTHING_TO_RESUME, EXIT_PREEMPTED  # noqa: F401


class NothingToResume(RuntimeError):
    """--resume restored a checkpoint past the configured step range."""


class Preempted(RuntimeError):
    """The run stopped at a boundary on SIGTERM. ``step`` is the last
    completed step, ``saved_step`` the emergency checkpoint's (None when no
    checkpoint was saved)."""

    def __init__(self, step: int, saved_step: Optional[int] = None):
        self.step = step
        self.saved_step = saved_step
        saved = (f"emergency checkpoint at step {saved_step}"
                 if saved_step is not None else "no checkpoint saved")
        super().__init__(f"preempted at step {step} ({saved})")


class PreemptionGuard:
    """Flag-only SIGTERM handler with install / uninstall bracketing.

    Disabled (``installed`` False) where handlers cannot be installed (a
    thread other than the main one): such runs keep the supervisor's kill.
    """

    def __init__(self, enabled: bool = True):
        self._requested = False
        self._prev = None
        self.installed = False
        self._published = False
        self._agreed_step: Optional[int] = None
        # The cross-rank agreement runs once, whatever its outcome: a dead
        # peer must not block every later boundary for the ack timeout.
        self._agreement_done = False
        if not enabled:
            return
        try:
            self._prev = signal.signal(signal.SIGTERM, self._on_sigterm)
            self.installed = True
        except (ValueError, OSError):
            pass

    def _on_sigterm(self, signum, frame) -> None:
        self._requested = True

    @property
    def requested(self) -> bool:
        return self._requested

    def coordinate(self, boundary_step: int) -> Optional[int]:
        """Poll at one fenced sync-window boundary: the step at which the loop
        must stop (the first boundary >= it), or None to keep running.

        One process: the local flag. Several: publish the local flag when
        set and poll every rank's flags without blocking; the ack agreement
        runs once (a degraded outcome is cached too), at the first boundary
        after the earliest flag's. Every step issues collectives, so no rank
        can finish the step after that boundary before the flag's rank has
        published it: every rank sees the flag by that boundary and enters
        the blocking agreement there, none earlier (a rank that waited at an
        earlier one would block the peers' next step)."""
        if self._agreement_done:
            if self._agreed_step is not None:
                return self._agreed_step
            return boundary_step if self._requested else None
        if dist_rt.get_world_size() <= 1:
            return boundary_step if self._requested else None
        if self._requested and not self._published:
            self._published = dist_rt.publish_preempt_flag(boundary_step)
        flags = dist_rt.preempt_flag_entries()
        if not flags or boundary_step <= min(step for _, step in flags):
            return None
        agreed = dist_rt.agree_preempt_step(boundary_step)
        if agreed is None:
            # A peer never acked (it died): stop here if we were signalled,
            # else keep running rather than wedge on the dead peer.
            agreed = boundary_step if self._requested else None
        self._agreed_step = agreed
        self._agreement_done = True
        return agreed

    def uninstall(self) -> None:
        """Restore the previous handler (idempotent)."""
        if not self.installed:
            return
        try:
            signal.signal(signal.SIGTERM, self._prev or signal.SIG_DFL)
        except (ValueError, OSError, TypeError):
            pass
        self.installed = False
