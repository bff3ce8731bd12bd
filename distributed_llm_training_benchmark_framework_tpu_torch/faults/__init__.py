"""Chaos harness: deterministic fault injection, preemption and the hang watchdog.

Port of ``distributed_llm_training_benchmark_framework_tpu/faults``:

- :mod:`.injection` — the registry of injectable faults, armed with the
  harness's ``--inject-fault`` flag or the ``INJECT_FAULT`` variable, each
  firing at an exact sync-window boundary;
- :mod:`.preemption` — the SIGTERM guard the loop polls at boundaries, the
  :class:`Preempted` control exception and :data:`EXIT_PREEMPTED`;
- :mod:`.watchdog` — the hang watchdog: a deadline on the boundary cadence
  that dumps every thread's stack into a ``hang_dump`` event, aborts every
  rank coherently over the group's store and exits :data:`EXIT_HUNG`;
- :mod:`.sentinel` — the numerics sentinel: boundary guards (loss envelope,
  global grad-norm, a parameter checksum every N steps) whose trip rolls
  the run back in process to the last validated checkpoint and replays,
  with ``n_rollbacks`` / ``rollback_steps_replayed`` on the row.

The exit codes the retrying orchestration keys on are re-exported here
from the package's ``exit_codes`` (which imports nothing, so the supervisor
reads them without torch): 75 (preempted), 76 (hung) and 78 (the input
stream stalled) are retryable with ``--resume``; 77 (nothing left to
resume) is terminal.
"""

from ..exit_codes import (  # noqa: F401
    EXIT_DATA_STALL,
    EXIT_HUNG,
    EXIT_NOTHING_TO_RESUME,
    EXIT_PREEMPTED,
)

from .injection import (  # noqa: F401
    ARMED_KINDS,
    DATA_KINDS,
    FAULT_KINDS,
    WAITS_FOR,
    FaultInjector,
    FaultSpec,
    parse_fault_spec,
)
from .preemption import (  # noqa: F401
    NothingToResume,
    Preempted,
    PreemptionGuard,
)
from .sentinel import NumericsSentinel, SentinelTripped  # noqa: F401
from .watchdog import HangWatchdog, Hung  # noqa: F401

__all__ = [
    "ARMED_KINDS",
    "DATA_KINDS",
    "EXIT_DATA_STALL",
    "EXIT_HUNG",
    "EXIT_NOTHING_TO_RESUME",
    "EXIT_PREEMPTED",
    "FAULT_KINDS",
    "FaultInjector",
    "FaultSpec",
    "HangWatchdog",
    "Hung",
    "NothingToResume",
    "NumericsSentinel",
    "Preempted",
    "PreemptionGuard",
    "SentinelTripped",
    "WAITS_FOR",
    "parse_fault_spec",
]
