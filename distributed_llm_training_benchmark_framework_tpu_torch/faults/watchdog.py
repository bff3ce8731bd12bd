"""Hang watchdog: a monotonic deadline on the sync-window cadence.

Port of ``distributed_llm_training_benchmark_framework_tpu/faults/watchdog.py``.
A hung collective, a wedged copy or a deadlocked host thread stops the
loop's sync-window events; without a watchdog an outside supervisor kills
the run minutes later with a generic code and no forensics. Here:

- the loop **beats** the watchdog at every sync-window boundary (two
  attribute writes);
- a daemon thread checks the deadline. When no boundary arrives within
  ``timeout_sec`` it dumps every thread's stack and the last beat into a
  ``hang_dump`` telemetry event and stderr, records ``run_aborted
  reason=hang`` and a final heartbeat, and exits :data:`EXIT_HUNG`
  (retryable with ``--resume``);
- in a process group the firing rank first publishes a hang flag on the
  group's TCP store (``runtime.distributed.publish_hang_flag``). Peers see
  it (the thread polls the namespace, and ranks still reaching boundaries
  poll it there) and abort with the same code. Nothing goes over NCCL: a
  wedged rank never joins a collective.

The deadline arms at the first beat (start-up and the first step's kernel
build may legitimately take minutes) and is disarmed before the finalize
tail.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Any, Callable, List, Optional, Tuple

from ..runtime import distributed as dist_rt

from ..exit_codes import EXIT_HUNG  # noqa: F401


class Hung(RuntimeError):
    """A peer rank's hang flag was seen at a boundary (this rank is healthy).
    The harness maps it to :data:`EXIT_HUNG` so every rank exits alike."""

    def __init__(self, step: int, peer: Optional[int] = None):
        self.step = step
        self.peer = peer
        who = f"rank {peer}" if peer is not None else "a peer rank"
        super().__init__(f"aborting at boundary step {step}: {who} reported a hang")


def _scan_peer_flags() -> Optional[Tuple[int, int]]:
    """(rank, step) of another rank's published hang flag, or None: the one
    scan behind both the loop's boundary poll and the watchdog thread."""
    if dist_rt.get_world_size() <= 1:
        return None
    me = dist_rt.get_rank()
    for rank, step in dist_rt.hang_flag_entries():
        if rank != me:
            return rank, step
    return None


def format_all_stacks() -> List[str]:
    """One formatted stack per live thread: the ``hang_dump`` payload."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: List[str] = []
    for ident, frame in sorted(sys._current_frames().items()):
        stack = "".join(traceback.format_stack(frame))
        out.append(f"Thread {names.get(ident, '?')} (ident {ident}):\n{stack}")
    return out


class HangWatchdog:
    """Deadline timer over the loop's sync-window beats. ``timeout_sec`` <= 0
    disables it (``armed`` False); ``recorder`` (a
    ``telemetry.TelemetryRecorder``) takes the ``hang_dump`` event, the
    ``run_aborted`` trail and the final heartbeat."""

    def __init__(self, timeout_sec: float = 0.0, *, recorder=None, rank: int = 0,
                 poll_interval_sec: Optional[float] = None,
                 _exit: Callable[[int], Any] = os._exit):
        self.timeout_sec = float(timeout_sec or 0.0)
        self.recorder = recorder
        self.rank = rank
        self._exit = _exit
        self.poll_interval_sec = (poll_interval_sec if poll_interval_sec is not None
                                  else max(min(self.timeout_sec / 4.0, 5.0), 0.05))
        self._last_beat: Optional[float] = None  # monotonic; None = unarmed
        self._last_step: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False

    @property
    def armed(self) -> bool:
        return self.timeout_sec > 0

    def beat(self, step: int) -> None:
        """A sync-window boundary arrived (attribute writes only)."""
        self._last_beat = time.monotonic()
        self._last_step = step

    def peer_hang(self) -> Optional[Tuple[int, int]]:
        """Non-blocking boundary poll: (rank, step) of a peer's hang flag, or
        None. Errors propagate to the main thread's caller."""
        if not self.armed:
            return None
        return _scan_peer_flags()

    def start(self) -> None:
        if not self.armed or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, name="hang-watchdog", daemon=True)
        self._thread.start()

    def disarm(self) -> None:
        """Stop the deadline thread (idempotent)."""
        self._stop.set()
        thread = self._thread
        self._thread = None
        if thread is not None and thread.is_alive():
            thread.join(timeout=2.0)

    def join_firing(self) -> None:
        """After the watchdog fired: wait for its thread, which ends the
        process with :data:`EXIT_HUNG`. The main thread calls it when it
        fails on its own meanwhile (a collective that broke because the hung
        peer exited), so the process does not exit with another code."""
        thread = self._thread
        if self.fired and thread is not None:
            thread.join()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_sec):
            last = self._last_beat
            if last is None:
                continue
            stalled = time.monotonic() - last
            if stalled > self.timeout_sec:
                self._fire(reason=(f"no sync-window boundary for {stalled:.1f}s (> "
                                   f"--hang-timeout-sec {self.timeout_sec:g}; last boundary "
                                   f"step {self._last_step})"))
                return
            peer = self._poll_peer_flag()
            if peer is not None:
                self._fire(reason=(f"peer rank {peer[0]} reported a hang at its boundary step "
                                   f"{peer[1]} (this rank last beat {stalled:.1f}s ago)"),
                           peer=peer[0])
                return

    def _poll_peer_flag(self) -> Optional[Tuple[int, int]]:
        """Thread-side peer poll, best effort: a rank blocked inside a
        collective never reaches another boundary, but this thread runs."""
        try:
            return _scan_peer_flags()
        except Exception:
            return None

    def _fire(self, reason: str, peer: Optional[int] = None) -> None:
        """Dump, publish, record, exit 76, on the watchdog thread (the main
        thread is stuck, so nothing here waits on it; ``os._exit`` skips
        teardown: the telemetry file is line-buffered)."""
        if self.fired:
            return
        self.fired = True
        stacks = format_all_stacks()
        if peer is None:
            # First, so the peers learn of the hang even if the dump wedges.
            try:
                dist_rt.publish_hang_flag(self._last_step or 0)
            except Exception:
                pass
        header = (f"HANG WATCHDOG (rank {self.rank}): {reason} — dumping {len(stacks)} "
                  f"thread stack(s) and exiting {EXIT_HUNG}")
        try:
            print(header, file=sys.stderr, flush=True)
            for s in stacks:
                print(s, file=sys.stderr, flush=True)
        except Exception:
            pass
        if self.recorder is not None:
            try:
                self.recorder.note("hang_dump", reason=reason, last_beat_step=self._last_step,
                                   timeout_sec=self.timeout_sec, peer_rank=peer, stacks=stacks)
                self.recorder.emergency_heartbeat(reason="hang",
                                                  extra={"last_beat_step": self._last_step})
                self.recorder.abort("hang")
            except Exception:
                pass
        _linger_for_coherent_exit(self.poll_interval_sec)
        self._exit(EXIT_HUNG)


def _linger_for_coherent_exit(poll_interval_sec: float) -> None:
    """In a group every aborting rank waits before dying, rank 0 (the TCP
    store's host) longest, so the peers read the flag before the store goes
    away. One process skips it."""
    try:
        if dist_rt.get_world_size() > 1:
            linger = min(max(2 * poll_interval_sec, 2.0), 10.0)
            if dist_rt.get_rank() == 0:
                linger += 2.0
            time.sleep(linger)
    except Exception:
        pass


def abort_on_peer_hang(recorder, step: int, peer: Tuple[int, int]) -> None:
    """Main-thread half of the coherent abort: the (stack-bearing) dump trail
    for a peer-reported hang, then :class:`Hung`."""
    rank, peer_step = peer
    if recorder is not None:
        try:
            recorder.note("hang_dump",
                          reason=(f"peer rank {rank} reported a hang at its boundary step "
                                  f"{peer_step}; this rank is healthy at boundary {step}"),
                          last_beat_step=step, peer_rank=rank, stacks=format_all_stacks())
            recorder.emergency_heartbeat(reason="hang", extra={"last_beat_step": step})
            recorder.abort("hang")
        except Exception:
            pass
    _linger_for_coherent_exit(1.0)
    raise Hung(step, peer=rank)
