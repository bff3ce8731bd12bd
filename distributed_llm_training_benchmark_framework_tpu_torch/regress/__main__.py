"""``python -m distributed_llm_training_benchmark_framework_tpu_torch.regress``."""

import sys

from .compare import main

if __name__ == "__main__":
    sys.exit(main())
