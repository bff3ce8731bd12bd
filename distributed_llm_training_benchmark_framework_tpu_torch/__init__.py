"""PyTorch / CUDA port of the TPU training benchmark framework, for NVIDIA
Hopper (H100).

Mirrors the layout of ``distributed_llm_training_benchmark_framework_tpu``
(the JAX package, which stays the reference): ``models``, ``ops`` (with the
hand-written CUDA kernels under ``csrc``), ``data``, ``parallel``, ``train``,
``utils``, plus ``bridge`` (JAX params as numpy -> port params) and ``bench``
(``python -m distributed_llm_training_benchmark_framework_tpu_torch.bench``).

The port imports torch and nothing of JAX or of the JAX package. Its entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
