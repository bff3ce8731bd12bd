"""Kernel microbenchmarks of the port (``python -m ...microbench.<name>``)."""
