"""Post-run analysis of the port's results: the validator, the telemetry
report, metrics.csv, plots, scaling curves and the Markdown report.

Port of the framework-neutral half of
``distributed_llm_training_benchmark_framework_tpu/analysis``. The analysis
tied to the backend (step and memory anatomy, the profile summary, the
static audit) is not ported yet (ROADMAP Queue 1 item 16).
"""

#: The memory-anatomy attribution classes, in report order: JAX's
#: ``analysis/memory_anatomy.ATTRIBUTION_CLASSES``, kept here alone (not its
#: module) for ``plot`` and ``make_report``, which render the
#: ``hbm_attr_<class>`` columns when a row carries them. Port rows carry no
#: attribution until item 16, so those sections are absent from their
#: plots and reports.
ATTRIBUTION_CLASSES = (
    "params", "grads", "opt_state", "activations", "dataset",
    "xla_temp", "unattributed",
)
