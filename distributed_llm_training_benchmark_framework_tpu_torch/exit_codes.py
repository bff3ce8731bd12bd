"""The exit codes the retrying orchestration keys on, in one module that
imports nothing, in a package whose ``__init__`` imports nothing: the
supervisor reads them without importing torch.

75 (preempted), 76 (hung) and 78 (the input stream stalled) are retryable
with ``--resume``; 77 (nothing left to resume) is terminal.
"""

#: Exit code of a preempted-but-checkpointed run: BSD's EX_TEMPFAIL
#: ("temporary failure, retry"), apart from crash codes and timeout(1)'s 124.
EXIT_PREEMPTED = 75

#: Exit code of a run aborted by the hang watchdog: apart from crash codes,
#: timeout(1)'s 124 and EXIT_PREEMPTED; retryable with --resume (the
#: checkpoints are intact, only the process wedged).
EXIT_HUNG = 76

#: Exit code of a --resume that found a checkpoint but no steps left to run.
#: Deterministic: a retry would refuse the same way, so wrappers stop.
EXIT_NOTHING_TO_RESUME = 77

#: Exit code for a run aborted as input-starved (``reason=data_stall``):
#: distinct from preempted (75) and hung (76) — the device was healthy and
#: the process alive, the INPUT path starved the timed loop. Retryable
#: with --resume: the emergency checkpoint + stream sidecar make the
#: retry consume exactly the un-consumed records.
EXIT_DATA_STALL = 78
