"""Chaos harness: deterministic fault injection, preemption and the hang watchdog.

Port of ``distributed_llm_training_benchmark_framework_tpu/faults``:

- :mod:`.injection` — the registry of injectable faults, armed with the
  harness's ``--inject-fault`` flag or the ``INJECT_FAULT`` variable, each
  firing at an exact sync-window boundary;
- :mod:`.preemption` — the SIGTERM guard the loop polls at boundaries, the
  :class:`Preempted` control exception and :data:`EXIT_PREEMPTED`;
- :mod:`.watchdog` — the hang watchdog: a deadline on the boundary cadence
  that dumps every thread's stack into a ``hang_dump`` event, aborts every
  rank coherently over the group's store and exits :data:`EXIT_HUNG`.

The exit codes the retrying orchestration keys on live here: 75
(preempted), 76 (hung) and 78 (the input stream stalled) are retryable
with ``--resume``; 77 (nothing left to resume) is terminal.
``EXIT_DATA_STALL`` is held here until the streaming input path
(``data/stream.py``) is ported and raises it.
"""

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
    EXIT_NOTHING_TO_RESUME,
    EXIT_PREEMPTED,
    NothingToResume,
    Preempted,
    PreemptionGuard,
)
from .watchdog import EXIT_HUNG, HangWatchdog, Hung  # noqa: F401

#: Exit code of a run whose streaming input starved the timed loop
#: (retryable with --resume); the JAX package's ``data/stream.py`` value.
EXIT_DATA_STALL = 78

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
    "Preempted",
    "PreemptionGuard",
    "WAITS_FOR",
    "parse_fault_spec",
]
