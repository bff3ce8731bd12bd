"""The host-offload arm: ZeRO-Offload with fp32 masters and AdamW on the host.

Port of the JAX package's offload optimizer (``parallel/strategies.py``:
``make_optimizer``'s offload state and ``offload_update_and_apply``). JAX
places that state in pinned host memory and runs the update there through
``compute_on("device_host")`` inside the jitted step; here the same state is
plain torch tensors in host memory and the update is eager torch on them.

**State.** For the tensors a rank's arm updates (``parallel/strategies.py``:
ddp's whole parameters, zero2's shards of its flat buffers, fsdp / zero3's
DTensor shards, each under ``model`` a tp shard), laid end to end in one
flat buffer per role:

- fp32 masters, upcast from the bf16 device parameters at construction, so
  they start bf16-rounded, as JAX's do;
- the AdamW moments and step (``torch.optim.AdamW`` over the flat masters,
  fused: one pass over the host arrays, where the foreach form makes about
  six, and both pass the JAX parity tests; its update equals optax's
  ``adamw``, and AdamW is elementwise, so one flat tensor updates as optax
  updates each leaf) and optax's update count ``count``, which the lr
  schedule reads before each update;
- a bf16 gradient slot (``stage``) and its fp32 clip scale, into which the
  device gradients are copied; in the delayed form it is the pending slot,
  zeros with scale 0 before the first delayed step;
- a bf16 upload buffer holding the compute copy of the masters.

On a CUDA device every one of these is pinned (``pin_memory=True``); a
failure to pin raises, with no fallback to pageable memory. Only where the
device is the CPU (the tests) are they ordinary tensors, and then "device"
and "host" are one memory and the same code path runs.

**Update** (``_update``), JAX's ``host_math``: ``g32 = f32(g) * scale``
(the scale folded into the upcast, none without a clip), AdamW on the
masters at ``lr = schedule(count)``, then the compute copy
``upload = bf16(masters)`` (round to nearest even, as ``astype``).

**Serial** (``step``): the arm's reduction has run; the gradients and the
scale are copied into the slot on a copy stream that waits for the
backward, the host waits for that copy's event, runs the update, and
copies the compute copy back into the device tensors in place on the copy
stream; the compute stream waits for that upload before the next step's
forward (and zero2's all-gather).

**Delayed** (DeepSpeed's ``delayed_param_update``; JAX
``offload_delayed_update``): ``begin_step`` (the arm's ``zero_grad``, at
the start of step t) starts a worker thread that applies the pending slot,
step t-1's gradients and scale, to the masters while the device runs step
t's forward and backward. ``step`` then joins it, parks step t's gradients
and scale in the slot, and uploads the compute copy the worker wrote. The
parameters lag one step. Step 0 applies the zero slot: with warmup (lr 0 at
count 0) the masters do not move; without, it is a weight-decay-only step,
and with moments from a serial phase (``begin_delayed`` after serial
steps) a zero-gradient update that still moves them, as in JAX. Ordering:
the worker touches host tensors only and waits on CUDA events (never a
CUDA tensor); it waits for the park's copy to land before reading the slot,
and for the last upload to finish before rewriting the upload buffer; the
upload is queued after the backward that read the old parameters. The
worker runs its intra-op work on all cores but two (``worker_threads``):
the step's dispatch thread runs beside it, and on an 8-core host the
delayed parity row ran faster at 6 or 7 threads than at 8, with the update
still hidden, and slower at 4, where it no longer was
(``scripts/torch_offload_threads.py``, ``PERF.md``); the serial update,
with the device idle, takes every core.

Times and bytes (``stats``): per step the host update's wall time (on the
worker in the delayed form), the device-to-host and host-to-device copies'
times on the copy stream's CUDA events (host wall time on the CPU), the
time ``step`` waited for the worker, and the host bytes held.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional

import torch


class _Worker:
    """One call of ``fn`` on a thread; ``join`` re-raises what it raised."""

    def __init__(self, fn: Callable[[], None]):
        self._error: Optional[BaseException] = None

        def run():
            try:
                fn()
            except BaseException as e:  # re-raised in join
                self._error = e

        self._thread = threading.Thread(target=run, name="host-offload-update")
        self._thread.start()

    def join(self) -> None:
        self._thread.join()
        if self._error is not None:
            raise self._error


class HostOffload:
    """The offload state of the device tensors ``tensors`` (updated in place)
    and its update; see the module docstring. ``schedule``: update count ->
    lr."""

    def __init__(self, strategy, tensors: List[torch.Tensor], schedule: Callable[[int], float]):
        dtypes = {t.dtype for t in tensors}
        if len(dtypes) != 1:
            raise ValueError(f"host offload takes tensors of one dtype, got "
                             f"{sorted(map(str, dtypes))}")
        self.tensors = tensors
        self.schedule = schedule
        self.clip = strategy.grad_clip is not None
        self.cuda = tensors[0].device.type == "cuda"
        (dtype,) = dtypes
        sizes = [t.numel() for t in tensors]
        n = sum(sizes)
        self.host_bytes = 0
        self.master = self._host(n, torch.float32)
        self.grad32 = self._host(n, torch.float32)
        self.stage = self._host(n, dtype)
        self.upload = self._host(n, dtype)
        self.scale = self._host((), torch.float32).fill_(1.0)
        views = lambda buf: list(torch.split(buf, sizes))
        self.master_views = [v.view(t.shape) for v, t in zip(views(self.master), tensors)]
        self.stage_views, self.upload_views = views(self.stage), views(self.upload)
        with torch.no_grad():
            for v, t in zip(self.master_views, tensors):
                v.copy_(t)
        self.master.grad = self.grad32
        self.adamw = torch.optim.AdamW(
            [self.master], lr=strategy.learning_rate, betas=strategy.betas, eps=strategy.eps,
            weight_decay=strategy.weight_decay, fused=True,
        )
        # The moments in the same memory as the masters (AdamW would make
        # them lazily, unpinned).
        self.adamw.state[self.master] = {
            "step": torch.zeros((), dtype=torch.float32),
            "exp_avg": self._host(n, torch.float32).zero_(),
            "exp_avg_sq": self._host(n, torch.float32).zero_(),
        }
        self.count = 0
        self.delayed = False
        self.worker_threads = max(1, (os.cpu_count() or 1) - 2)
        self._worker: Optional[_Worker] = None
        self._d2h_done = self._h2d_done = None
        self.copy_stream = torch.cuda.Stream(tensors[0].device) if self.cuda else None
        self._times: Dict[str, list] = {"host_update_ms": [], "wait_ms": [], "d2h": [], "h2d": []}
        if strategy.offload_delayed_update:
            self.begin_delayed()

    def _host(self, shape, dtype: torch.dtype) -> torch.Tensor:
        t = torch.empty(shape, dtype=dtype, pin_memory=self.cuda)
        if self.cuda and not t.is_pinned():
            raise RuntimeError(f"host offload: a {t.nbytes}-byte host buffer is not pinned")
        self.host_bytes += t.nbytes
        return t

    def begin_delayed(self) -> None:
        """Switch to the delayed update (between steps): an empty pending
        slot with scale 0, which the next step applies (JAX's serial ->
        delayed transition; its "momentum ghost")."""
        self.stage.zero_()
        self.scale.zero_()
        self.delayed = True

    def begin_step(self) -> None:
        """At the start of a step: the delayed form starts the worker that
        applies the pending slot."""
        if self.delayed and self._worker is None:
            self._worker = _Worker(self._update_pending)

    def step(self, grads: List[torch.Tensor], scale: Optional[torch.Tensor]) -> None:
        """After the arm's reduction: the host update of this step's
        gradients (serial), or of the pending ones, with this step's parked
        in their place (delayed); then the upload of the compute copy."""
        if len(grads) != len(self.tensors) or any(g is None for g in grads):
            raise ValueError("host offload: every tensor needs its gradient")
        if not self.delayed:
            self._download(grads, scale)
            self._wait(self._d2h_done)
            self._update()
        else:
            if self._worker is None:
                raise RuntimeError("delayed host update: the step did not start it "
                                   "(the arm's zero_grad begins a step)")
            t0 = time.perf_counter()
            self._worker.join()
            self._worker = None
            self._times["wait_ms"].append(1e3 * (time.perf_counter() - t0))
            self._download(grads, scale)
        self._upload()

    @staticmethod
    def _wait(event) -> None:
        if event is not None:
            event.synchronize()

    def _update_pending(self) -> None:
        threads = torch.get_num_threads()
        torch.set_num_threads(self.worker_threads)
        try:
            self._wait(self._d2h_done)
            self._update()
        finally:
            torch.set_num_threads(threads)

    @torch.no_grad()
    def _update(self) -> None:
        t0 = time.perf_counter()
        self.grad32.copy_(self.stage)
        if self.clip:
            self.grad32.mul_(self.scale)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        self._wait(self._h2d_done)  # the last upload has read the buffer
        self.upload.copy_(self.master)
        self._times["host_update_ms"].append(1e3 * (time.perf_counter() - t0))

    def _copies(self, kind: str, pairs) -> Optional[torch.cuda.Event]:
        """Copy each (dst, src) pair; on a CUDA device on the copy stream
        after the work queued so far, returning its completion event."""
        if not self.cuda:
            t0 = time.perf_counter()
            for dst, src in pairs:
                dst.copy_(src)
            self._times[kind].append(1e3 * (time.perf_counter() - t0))
            return None
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        self.copy_stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.copy_stream):
            start.record()
            for dst, src in pairs:
                dst.copy_(src, non_blocking=True)
            end.record()
        self._times[kind].append((start, end))
        return end

    def _download(self, grads: List[torch.Tensor], scale: Optional[torch.Tensor]) -> None:
        pairs = [(v, g.reshape(-1)) for v, g in zip(self.stage_views, grads)]
        if scale is not None:
            pairs.append((self.scale, scale))
        self._d2h_done = self._copies("d2h", pairs)

    @torch.no_grad()
    def _upload(self) -> None:
        self._h2d_done = self._copies(
            "h2d", [(t.view(-1), v) for t, v in zip(self.tensors, self.upload_views)])
        if self._h2d_done is not None:
            torch.cuda.current_stream().wait_event(self._h2d_done)

    def stats(self) -> dict:
        """Per-step times (ms) and bytes so far; on a CUDA device, waits for
        the copies queued."""
        def ms(entries):
            out = []
            for e in entries:
                if isinstance(e, tuple):
                    e[1].synchronize()
                    e = e[0].elapsed_time(e[1])
                out.append(e)
            return out

        return {
            "host_update_ms": list(self._times["host_update_ms"]),
            "wait_ms": list(self._times["wait_ms"]),
            "d2h_ms": ms(self._times["d2h"]),
            "h2d_ms": ms(self._times["h2d"]),
            "d2h_bytes": self.stage.nbytes + (self.scale.nbytes if self.clip else 0),
            "h2d_bytes": self.upload.nbytes,
            "host_bytes": self.host_bytes,
            "pinned": self.cuda,
            "elements": self.master.numel(),
            "cpu_count": os.cpu_count(),
            "threads": self.worker_threads if self.delayed else torch.get_num_threads(),
        }
