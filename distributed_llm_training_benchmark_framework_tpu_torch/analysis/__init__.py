"""Post-run analysis of the port's results: the validator, the telemetry
report, metrics.csv, plots, scaling curves, the Markdown report, and the
analysis tied to the backend: the profile summary and the step anatomy
over ``torch.profiler`` traces, and the memory anatomy over the CUDA
allocator.

Port of ``distributed_llm_training_benchmark_framework_tpu/analysis``; its
static audit (graftcheck) is ``analysis/static``.
"""

from .memory_anatomy import ATTRIBUTION_CLASSES

__all__ = ["ATTRIBUTION_CLASSES"]
