"""Post-run analysis of the port's results: the validator, the telemetry
report, metrics.csv, plots, scaling curves, the Markdown report, and the
analysis tied to the backend: the profile summary and the step anatomy
over ``torch.profiler`` traces, and the memory anatomy over the CUDA
allocator.

Port of ``distributed_llm_training_benchmark_framework_tpu/analysis`` but
its static audit (``analysis/static``: ROADMAP Queue 1 item 16b).
"""

from .memory_anatomy import ATTRIBUTION_CLASSES

__all__ = ["ATTRIBUTION_CLASSES"]
