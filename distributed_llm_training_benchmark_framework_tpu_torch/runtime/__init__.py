"""The distributed runtime: process-group start-up and teardown, the barrier,
and the preempt / hang flags between ranks (``runtime.distributed``)."""
