"""Bounded double-buffered host prefetch with a non-blocking copy to the card.

Port of ``distributed_llm_training_benchmark_framework_tpu/data/prefetch.py``,
the consumer half of the streaming input path (``data/stream.py`` is the
durable half). One producer thread reads the next batches off the shard
stream and starts their copy to the card, so the timed loop overlaps input
IO with device compute. JAX's design stands:

- **Bounded queue (depth 2, a double buffer).** The producer runs at most
  ``depth`` batches ahead, and every batch carries its own cursor snapshot:
  the loop persists the snapshot of the batch it *consumed*, never the
  read-ahead position.
- **Starvation is measured, then classified.** ``get()`` returns how long
  the loop waited (the loop folds it into ``data_stall_frac``); past its
  timeout it raises :class:`DataStallTimeout` and the loop stops the run as
  ``reason=data_stall`` (exit 78), not as the watchdog's hang.
- **Producer errors surface in the consumer.** An exception on the thread
  is re-raised from ``get()`` once the batches before it are consumed.

JAX's ``device_put`` / ``make_array_from_callback`` become this rank's own
rows: for each of the step's ``grad_accum`` micro-batches the records
``cursor + a * global_micro + row0 .. + micro`` (this rank's rows of the
global micro-batch, as its callback reads them), with the sequence shard's
columns cut after the read. They are written as int64 (the synthetic
table's dtype) into a pinned host buffer and copied to the card with
``non_blocking=True`` on a copy stream of the producer's; ``get()`` makes
the consumer's current stream wait on that copy's event (and records the
batch on it for the allocator). A pinned buffer is refilled only after its
last copy's event completed. Under ``--device cpu`` the rows stay in
ordinary host memory: no pinning, no stream.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .stream import ShardedTokenStream

#: Producer-side poll cadence of the bounded queue put (keeps the thread
#: responsive to stop()).
_PUT_POLL_SEC = 0.2
#: Consumer-side poll cadence while waiting on a batch.
_GET_POLL_SEC = 0.05


class DataStallTimeout(RuntimeError):
    """``get()`` starved past the configured timeout."""

    def __init__(self, step: int, waited_sec: float):
        self.step = step
        self.waited_sec = waited_sec
        super().__init__(f"no batch for step {step} after {waited_sec:.1f}s")


class HostPrefetcher:
    """Background producer of this rank's step batches on ``device``.

    Produces the batches of steps ``start_step .. stop_step - 1`` in order,
    from ``stream.cursor`` on; each queue item is ``(step, batch, copy
    event, meta)``, ``meta`` the stream's exact-resume snapshot *after* that
    batch (``cursor``, ``records_skipped``). ``row0`` / ``micro`` are this
    rank's rows of each global micro-batch of ``global_micro`` rows, and
    ``seq_shard`` ``(s, n)`` its columns of the sequence."""

    def __init__(self, stream: ShardedTokenStream, *, grad_accum: int, global_micro: int,
                 seq_len: int, start_step: int, stop_step: int, device: torch.device,
                 row0: int = 0, micro: Optional[int] = None, seq_shard: Tuple[int, int] = (0, 1),
                 depth: int = 2, injector: Any = None):
        self.stream = stream
        self.grad_accum = int(grad_accum)
        self.global_micro = int(global_micro)
        self.seq_len = int(seq_len)
        self.start_step = int(start_step)
        self.stop_step = int(stop_step)
        self.records_per_step = self.grad_accum * self.global_micro
        self.row0 = int(row0)
        self.micro = int(micro if micro is not None else global_micro)
        s, n = seq_shard
        cols = self.seq_len // n
        self.cols = slice(s * cols, (s + 1) * cols)
        self.device = torch.device(device)
        self.injector = injector
        self.cuda = self.device.type == "cuda"
        self.copy_stream = torch.cuda.Stream(self.device) if self.cuda else None
        shape = (self.grad_accum, self.micro, cols)
        # One more pinned buffer than the queue holds: the consumer's batch
        # may still be copying while the queue is full.
        self._host = [torch.empty(shape, dtype=torch.int64, pin_memory=self.cuda)
                      for _ in range(max(int(depth), 1) + 1)]
        self._copied: list = [None] * len(self._host)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._produce, name="data-prefetch", daemon=True)

    def start(self) -> "HostPrefetcher":
        self._thread.start()
        return self

    # -- producer (prefetch thread) ------------------------------------------

    def read_rows(self, cursor: int) -> np.ndarray:
        """This rank's rows of the step batch starting at ``cursor``:
        (accum, micro, S/n) int32, read straight off the stream."""
        out = []
        for a in range(self.grad_accum):
            base = cursor + a * self.global_micro + self.row0
            out.append(self.stream.read_records(base, base + self.micro)[:, self.cols])
        return np.stack(out, axis=0)

    def _put_on_device(self, slot: int, rows: np.ndarray):
        """Rows into pinned buffer ``slot`` (once its last copy is done),
        then onto the card on the copy stream -> (batch, copy event)."""
        host = self._host[slot]
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()
        host.numpy()[...] = rows
        if not self.cuda:
            return host.clone(), None
        with torch.cuda.stream(self.copy_stream):
            batch = torch.empty(host.shape, dtype=host.dtype, device=self.device)
            batch.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.copy_stream)
        self._copied[slot] = done
        return batch, done

    def _produce(self) -> None:
        try:
            cursor = self.stream.cursor
            for k, produced in enumerate(range(self.start_step, self.stop_step)):
                inj = self.injector
                if inj is not None and hasattr(inj, "data_stall_sec"):
                    stall = inj.data_stall_sec(produced)
                    if stall > 0:
                        # The injected outage: the producer sleeps and the
                        # consumer starves past its timeout.
                        self._stop.wait(stall)
                if self._stop.is_set():
                    return
                batch, done = self._put_on_device(k % len(self._host), self.read_rows(cursor))
                cursor += self.records_per_step
                self.stream.cursor = cursor
                meta: Dict[str, Any] = {"step": produced, "cursor": cursor,
                                        "records_skipped": self.stream.records_skipped}
                while not self._stop.is_set():
                    try:
                        self._q.put((produced, batch, done, meta), timeout=_PUT_POLL_SEC)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced by get(); never a dead queue
            self._error = e

    # -- consumer (main thread) ----------------------------------------------

    def get(self, step: int, timeout: float = 60.0) -> Tuple[torch.Tensor, Dict[str, Any], float]:
        """The batch for ``step`` -> (batch on the device, resume meta,
        seconds waited). The caller's current stream waits on the batch's
        copy. Raises :class:`DataStallTimeout` when no batch lands within
        ``timeout`` seconds, and re-raises a producer error. Steps are asked
        for in production order."""
        t0 = time.perf_counter()
        while True:
            try:
                got_step, batch, done, meta = self._q.get(timeout=_GET_POLL_SEC)
            except queue.Empty:
                # Batches already produced are progress: an error two steps
                # ahead surfaces once the consumer reaches it.
                if self._error is not None:
                    raise self._error
                waited = time.perf_counter() - t0
                if waited >= timeout:
                    raise DataStallTimeout(step, waited)
                continue
            if got_step != step:
                raise RuntimeError(f"prefetch order broke: wanted step {step}, queue held step "
                                   f"{got_step}")
            if done is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(done)
                batch.record_stream(current)
            return batch, meta, time.perf_counter() - t0

    def stop(self, join: bool = False, timeout: float = 10.0) -> None:
        """Ask the producer to exit; with ``join`` also wait for it, draining
        the queue so a producer blocked on a full queue sees the stop. The
        join is the rollback's: the producer advances ``stream.cursor`` as
        it reads ahead, so a ``seek`` under a live producer could be
        overwritten by a batch in flight."""
        self._stop.set()
        if not join:
            return
        deadline = time.perf_counter() + timeout
        while self._thread.is_alive() and time.perf_counter() < deadline:
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=_PUT_POLL_SEC)
