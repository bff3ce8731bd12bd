"""Deterministic fault injection for the chaos harness.

Port of ``distributed_llm_training_benchmark_framework_tpu/faults/injection.py``:
the same registry of kinds, the same ``--inject-fault`` grammar and errors,
and ``INJECT_FAULT`` as the fallback when no flag is given. Every armed
fault fires at an exact, reproducible point:

- the stepped kinds (``sigkill@N``, ``sigterm@N``, ``sigterm-rank@N:R``,
  ``hang@N[:SECS]``, ``stall-rank@N:R[:SECS]``) fire at the first
  sync-window boundary whose last completed step is >= N;
- ``nan-loss@N`` turns step N's loss into NaN as it is dispatched;
- ``bitflip@N`` / ``grad-explode@N`` poison the parameters just before step
  N dispatches (one huge element / one scaled leaf) and ``opt-moments@N``
  the AdamW moments: the numerics sentinel's proof faults
  (``faults/sentinel.py``), which the run must detect, roll back and replay;
- ``torn-checkpoint`` fires after the first save that leaves a *previous*
  committed step behind it: it truncates one file of the newest step and
  SIGKILLs, so the resume must quarantine that step and fall back;
- ``enospc-on-save`` raises ``OSError(ENOSPC)`` from every save: the run
  must degrade (a warning and a telemetry event) and still finish.

- the ``data-*`` kinds fire inside the streaming input path
  (``data/stream.py``, ``data/prefetch.py``) through the ``data_*`` hooks,
  at an exact record, shard or step, without touching the shard files.

Every kind is armed (``ARMED_KINDS``; ``WAITS_FOR`` is empty). A fault
announces itself with a ``fault_injected`` telemetry event before firing
(the JSONL is line-buffered, so even a SIGKILL's trail records what killed
it).
"""

from __future__ import annotations

import dataclasses
import errno
import os
import signal
import time
from typing import Optional

#: kind -> one-line contract, the registry --inject-fault validates against.
FAULT_KINDS = {
    "sigkill": "SIGKILL self at the first sync boundary with step >= N "
               "(the honest crash: no handlers, no flushes)",
    "sigterm": "SIGTERM self at the first sync boundary with step >= N "
               "(exercises the preemption handler end to end)",
    "sigterm-rank": "sigterm-rank@N:R — SIGTERM self at the first sync "
                    "boundary with step >= N, but ONLY on rank R "
                    "(exercises the cross-rank preempt-soon broadcast: "
                    "every OTHER rank must learn of the preemption from "
                    "the process group's store flag, not a signal)",
    "nan-loss": "corrupt step N's loss to NaN (trips the recorder's "
                "anomaly screen; validate_results must reject the row)",
    "hang": "sleep at the first sync boundary with step >= N "
            "(hang@N:SECS overrides the default stall; exercises the "
            "in-process hang watchdog / the liveness probe)",
    "stall-rank": "stall-rank@N:R[:SECS] — sleep at the first sync "
                  "boundary with step >= N, but ONLY on rank R "
                  "(exercises the cross-rank hang broadcast: every OTHER "
                  "rank must learn of the stall from the process "
                  "group's store hang flag and join the coherent "
                  "EXIT_HUNG abort)",
    "bitflip": "bitflip@N — corrupt one element of one parameter leaf "
               "before step N dispatches (silent-data-corruption "
               "analogue; the numerics sentinel's checksum/grad guards "
               "must trip and roll back)",
    "grad-explode": "grad-explode@N — scale one parameter leaf by a large "
                    "factor before step N dispatches, so the step's "
                    "global grad-norm explodes (the sentinel's grad-norm "
                    "guard must trip and roll back)",
    "opt-moments": "opt-moments@N — collapse the optimizer's second-"
                   "moment (Adam nu) accumulators toward zero before "
                   "step N dispatches: step N's update explodes (m/"
                   "(sqrt(nu)+eps) with a vanishing denominator) while "
                   "step N's own loss/grads stay healthy, so step N+1's "
                   "global grad-norm spikes FIRST — the sentinel's "
                   "grad-norm guard must trip before the loss/checksum "
                   "guards and roll back",
    "torn-checkpoint": "tear the newest checkpoint after a save that has "
                       "a previous committed step, then SIGKILL (restore "
                       "must quarantine and fall back)",
    "enospc-on-save": "every checkpoint save raises OSError(ENOSPC); the "
                      "run must degrade and still finish",
    "data-stall": "data-stall@N[:SECS] — the streaming input source goes "
                  "silent before the batch for step N (default stall "
                  "3600 s): the prefetch producer sleeps, the timed loop "
                  "starves, and the run must classify reason=data_stall "
                  "(exit 78, retryable-with-resume) — NOT the watchdog's "
                  "hang. Requires --data-path",
    "data-corrupt-record": "data-corrupt-record@N — flip one byte of "
                           "global record N's payload as it is read "
                           "(emulated disk bit-rot; the files are never "
                           "mutated): the CRC check must catch it, the "
                           "slot heals by substitution, and the "
                           "records_skipped ledger + data_corrupt_record "
                           "telemetry event record the quarantine. "
                           "Requires --data-path",
    "data-slow-reader": "data-slow-reader@N:MS — every record read from "
                        "global record N onward takes MS extra "
                        "milliseconds (a degraded mount): the run must "
                        "COMPLETE with an honest, elevated "
                        "data_stall_frac — degrade, never die. Requires "
                        "--data-path",
    "data-missing-shard": "data-missing-shard@K — shard K is withheld "
                          "from discovery (a hole in the corpus): the "
                          "stream must REFUSE loudly naming the shard "
                          "before any device work — training on a "
                          "silently truncated corpus is the failure this "
                          "proves impossible. Requires --data-path",
}

#: Kinds that take a mandatory ``@N`` step (for the data kinds, N is a
#: global record index / shard index rather than an optimizer step — the
#: same "a fault without a firing point is not reproducible" rule).
STEPPED_KINDS = frozenset(
    {"sigkill", "sigterm", "sigterm-rank", "nan-loss", "hang",
     "stall-rank", "bitflip", "grad-explode", "opt-moments",
     "data-stall", "data-corrupt-record", "data-slow-reader",
     "data-missing-shard"}
)

#: Kinds whose ``@N:R`` suffix names a target rank.
RANKED_KINDS = frozenset({"sigterm-rank", "stall-rank"})

#: Data-path kinds (fire inside data/stream.py + data/prefetch.py via the
#: injector's data_* hooks; require --data-path to have any consumer).
DATA_KINDS = frozenset(
    {"data-stall", "data-corrupt-record", "data-slow-reader",
     "data-missing-shard"}
)

#: The bitflip magnitude: its square overflows fp32, so the sentinel's
#: checksum and grad-norm guards trip at the next boundary.
BITFLIP_VALUE = 1e30
#: grad-explode scales one leaf by this factor: logits saturate and the loss
#: and grad-norm jump by orders of magnitude without going non-finite (the
#: envelope guards must catch it, not a NaN screen).
GRAD_EXPLODE_SCALE = 1e3
#: opt-moments: the second moments collapse and the first moments burst.
#: A collapse alone cannot spike the next step (AdamW refills the
#: denominator with (1 - b2) g^2 within the corrupted step); the first
#: moment keeps its corruption through b1 * m, so the update explodes
#: while the corrupted step's own loss and gradients stay healthy, and the
#: next step's grad-norm is the first symptom.
MOMENT_COLLAPSE_SCALE = 1e-8
MOMENT_BURST_SCALE = 1e4

#: Default stall for ``hang`` when the spec carries no ``:SECS``. Long
#: enough that any sane per-run timeout (or the k8s liveness probe) fires
#: first; the chaos suite passes a short override.
HANG_DEFAULT_SEC = 3600.0


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One parsed ``--inject-fault`` value."""

    kind: str
    step: Optional[int] = None
    hang_sec: Optional[float] = None
    # sigterm-rank@N:R — the one rank that receives the signal. Every rank
    # parses the same spec (the suite passes one value to every worker);
    # the injector compares against its own rank at fire time.
    rank: Optional[int] = None
    # data-slow-reader@N:MS — per-record extra read latency in
    # milliseconds (its own field so the spec string round-trips in the
    # unit the operator wrote; hang_sec stays seconds).
    delay_ms: Optional[float] = None

    def __str__(self) -> str:
        s = self.kind
        if self.step is not None:
            s += f"@{self.step}"
        if self.rank is not None:
            # Ranked grammar: KIND@N:R[:SECS] — the rank rides first.
            s += f":{self.rank}"
        if self.hang_sec is not None:
            s += f":{self.hang_sec:g}"
        if self.delay_ms is not None:
            s += f":{self.delay_ms:g}"
        return s


def parse_fault_spec(spec: Optional[str]) -> Optional[FaultSpec]:
    """``"sigkill@10"`` -> FaultSpec; None/empty -> None; junk raises.

    Grammar: ``KIND`` | ``KIND@STEP`` | ``hang@STEP:SECS`` |
    ``sigterm-rank@STEP:RANK`` | ``stall-rank@STEP:RANK[:SECS]``.
    Stepped kinds *require* the step (a fault with no defined firing
    point would not be reproducible) — the ranked kinds additionally
    require the target rank; the save-path kinds refuse one (they fire on
    save events, not steps).
    """
    if not spec:
        return None
    spec = spec.strip()
    kind, _, rest = spec.partition("@")
    if kind not in FAULT_KINDS:
        raise ValueError(
            f"unknown fault kind {kind!r} (expected one of "
            f"{sorted(FAULT_KINDS)})"
        )
    if kind in STEPPED_KINDS:
        if not rest:
            raise ValueError(
                f"fault {kind!r} needs an explicit step: {kind}@N "
                "(a fault without a firing step is not reproducible)"
            )
        step_str, _, suffix = rest.partition(":")
        if suffix and kind not in (
            "hang", "data-stall", "data-slow-reader", *RANKED_KINDS
        ):
            raise ValueError(
                f"only 'hang', 'data-stall', 'data-slow-reader' and the "
                f"ranked kinds ({sorted(RANKED_KINDS)}) take a suffix, "
                f"got {spec!r}"
            )
        if kind in RANKED_KINDS and not suffix:
            raise ValueError(
                f"{kind} needs a target rank: {kind}@N:R (without one the "
                f"fault is rankless — which rank it hits is the whole "
                "point of the spec)"
            )
        if kind == "data-slow-reader" and not suffix:
            raise ValueError(
                f"data-slow-reader needs a per-record latency: "
                f"data-slow-reader@N:MS (without one the degradation it "
                f"injects is undefined), got {spec!r}"
            )
        try:
            step = int(step_str)
        except ValueError:
            raise ValueError(f"fault step must be an integer, got {spec!r}")
        if step < 0:
            raise ValueError(f"fault step must be >= 0, got {spec!r}")
        hang_sec = None
        rank = None
        delay_ms = None
        if suffix and kind == "data-slow-reader":
            try:
                delay_ms = float(suffix)
            except ValueError:
                raise ValueError(
                    f"data-slow-reader latency must be a number of "
                    f"milliseconds, got {spec!r}"
                )
            if delay_ms <= 0:
                raise ValueError(
                    f"data-slow-reader latency must be > 0, got {spec!r}"
                )
            return FaultSpec(kind=kind, step=step, delay_ms=delay_ms)
        if suffix and kind in RANKED_KINDS:
            rank_str, _, secs_str = suffix.partition(":")
            if secs_str and kind != "stall-rank":
                raise ValueError(
                    f"only stall-rank takes a duration suffix, got {spec!r}"
                )
            try:
                rank = int(rank_str)
            except ValueError:
                raise ValueError(
                    f"{kind} target must be an integer rank, got {spec!r}"
                )
            if rank < 0:
                raise ValueError(f"fault rank must be >= 0, got {spec!r}")
            if secs_str:
                try:
                    hang_sec = float(secs_str)
                except ValueError:
                    raise ValueError(
                        f"stall duration must be a number, got {spec!r}"
                    )
                if hang_sec <= 0:
                    raise ValueError(
                        f"stall duration must be > 0, got {spec!r}"
                    )
        elif suffix:
            try:
                hang_sec = float(suffix)
            except ValueError:
                raise ValueError(
                    f"hang duration must be a number, got {spec!r}"
                )
            if hang_sec <= 0:
                raise ValueError(f"hang duration must be > 0, got {spec!r}")
        return FaultSpec(kind=kind, step=step, hang_sec=hang_sec, rank=rank)
    if rest:
        raise ValueError(
            f"fault {kind!r} fires on checkpoint saves and takes no @step "
            f"(got {spec!r})"
        )
    return FaultSpec(kind=kind)



#: The kinds this injector fires: all of them.
ARMED_KINDS = frozenset(FAULT_KINDS)

#: The parsed kinds that have no consumer in the port yet -> what they wait for.
WAITS_FOR: dict = {}


def _jax_path_str(path: tuple) -> str:
    """``str`` of the JAX tree path of a leaf (a tuple of ``DictKey``), the
    tie-break of the JAX injector's victim sort; ``path`` is the leaf's
    bridge path without the layer index."""
    return "(" + ", ".join(f"DictKey(key={k!r})" for k in path) + ("," if len(path) == 1
                                                                    else "") + ")"


def _owns_first_element(model, name: str, p) -> bool:
    """Whether this rank's part of parameter ``name`` holds the global
    element ``[0, ...]`` of its leaf: the first shard on every ``model`` /
    ``expert`` axis that cuts it, and a DTensor shard at global offset 0."""
    from .. import bridge

    if any(index != 0 for _ax, index, _n, _g in bridge.shard_axes(model, name)):
        return False
    from torch.distributed.tensor import DTensor

    if isinstance(p, DTensor):
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        shape, offset = compute_local_shape_and_global_offset(p.shape, p.device_mesh,
                                                              p.placements)
        return all(o == 0 for o in offset) and all(n > 0 for n in shape)
    return p.numel() > 0


def corruption_victim(model, grad_explode: bool = False) -> tuple:
    """The JAX injector's victim leaf on a port model: the largest leaf of
    the global tree (a block leaf counts all its layers, as JAX stacks them),
    ties broken on the JAX path's ``str``; ``grad_explode`` keeps the
    leaves named ``wte``. -> (JAX path without the layer index, its global
    stacked size). Needs no communication: sizes come from the config."""
    import math

    from .. import bridge

    sizes = {}
    for (path, p), (name, _) in zip(bridge.leaf_map(model), model.named_parameters()):
        leaf = path[:2] if path[0] == "blocks" else path
        layers = model.config.n_layer if path[0] == "blocks" else 1
        sizes[leaf] = math.prod(bridge.global_shape(model, name, p)) * layers
    if grad_explode:
        named = {k: v for k, v in sizes.items() if "wte" in _jax_path_str(k)}
        sizes = named or sizes
    victim = sorted(sizes, key=lambda k: (-sizes[k], _jax_path_str(k)))[0]
    return victim, sizes[victim]


def _tear_newest_file(step_dir: str) -> Optional[str]:
    """Truncate the first (sorted) non-empty file under ``step_dir``; the torn
    path, or None when nothing could be torn. A deterministic pick, so the
    torn artifact is the same on every run."""
    candidates = []
    for dirpath, _dirnames, filenames in os.walk(step_dir):
        for fn in sorted(filenames):
            path = os.path.join(dirpath, fn)
            try:
                if os.path.getsize(path) > 0:
                    candidates.append(path)
            except OSError:
                continue
    if not candidates:
        return None
    victim = sorted(candidates)[0]
    size = os.path.getsize(victim)
    with open(victim, "r+b") as f:
        f.truncate(max(size // 2, 1) - 1 if size > 1 else 0)
    return victim


class FaultInjector:
    """Arms one :class:`FaultSpec` against the train loop's boundaries. Call
    sites, all at device-fenced points (the injector adds no sync):
    :meth:`at_boundary` at the end of ``sync_window``, :meth:`corrupt_loss`
    on each dispatched loss, :meth:`corrupt_params` and
    :meth:`corrupt_opt_state` before each dispatch, :meth:`maybe_fail_save`
    before a save and :meth:`after_save` after one; the streaming input path
    calls the ``data_*`` hooks. Inert without a spec."""

    def __init__(self, spec: Optional[FaultSpec] = None, recorder=None, is_main: bool = True,
                 rank: int = 0):
        self.spec = spec
        self.recorder = recorder
        self.is_main = is_main
        self.rank = rank
        self.fired = False

    def _announce(self, detail: str) -> None:
        if self.recorder is not None:
            try:
                self.recorder.note("fault_injected", fault=str(self.spec), detail=detail)
            except Exception:
                pass
        if self.is_main:
            print(f"CHAOS: injecting fault {self.spec} — {detail}", flush=True)

    def at_boundary(self, last_step: int) -> None:
        """Fire sigkill / sigterm / hang / stall at the first boundary past N."""
        if (self.spec is None or self.fired
                or self.spec.kind not in ("sigkill", "sigterm", "sigterm-rank", "hang",
                                          "stall-rank")
                or last_step < (self.spec.step or 0)):
            return
        if self.spec.kind in RANKED_KINDS and self.rank != (self.spec.rank or 0):
            # Not this rank's fault: it must learn of the preemption or the
            # hang from the store's flags, which is what the spec proves.
            return
        self.fired = True
        kind = self.spec.kind
        if kind in ("sigkill", "sigterm", "sigterm-rank"):
            sig = signal.SIGKILL if kind == "sigkill" else signal.SIGTERM
            who = f" (rank {self.rank})" if kind == "sigterm-rank" else ""
            self._announce(f"{sig.name}{who} at sync boundary, step {last_step}")
            os.kill(os.getpid(), sig)
        else:
            secs = self.spec.hang_sec or HANG_DEFAULT_SEC
            what = (f"stall (rank {self.rank}, {secs:g}s)" if kind == "stall-rank"
                    else f"hang ({secs:g}s stall)")
            self._announce(f"{what} at sync boundary, step {last_step}")
            time.sleep(secs)

    def corrupt_loss(self, step: int, loss):
        """NaN exactly step N's loss for ``nan-loss@N`` (else passthrough)."""
        if (self.spec is None or self.fired or self.spec.kind != "nan-loss"
                or step != self.spec.step):
            return loss
        self.fired = True
        self._announce(f"NaN loss injected at step {step}")
        return loss * float("nan")

    # -- parameter and optimizer-state corruption (the sentinel's proofs) --

    def corrupt_params(self, step: int, model) -> None:
        """Poison the parameters in place just before step N dispatches, for
        ``bitflip@N`` (element ``[0, ...]`` of the JAX injector's victim leaf
        set to :data:`BITFLIP_VALUE`) and ``grad-explode@N`` (the ``wte``
        leaf scaled by :data:`GRAD_EXPLODE_SCALE`); else nothing.

        ``model`` is the TinyGPT the arm wraps. A block leaf's element
        ``[0, ...]`` is global layer 0's. Where the leaf is sharded (a
        ``model`` or ``expert`` axis, FSDP2's DTensor shards) only the rank
        holding the global element writes it; a replicated leaf (DDP,
        zero2's gathered buffers, a pipeline's shared leaves) is written on
        every rank that holds it, as JAX writes every replica of its global
        array."""
        if (self.spec is None or self.fired or self.spec.kind not in ("bitflip", "grad-explode")
                or step != self.spec.step):
            return
        self.fired = True
        import torch

        from .. import bridge

        victim, _size = corruption_victim(model, grad_explode=self.spec.kind == "grad-explode")
        label = "params" + "".join(f"[{k!r}]" for k in victim)
        with torch.no_grad():
            for (path, p), (name, _) in zip(bridge.leaf_map(model), model.named_parameters()):
                if tuple(path[:len(victim)]) != victim:
                    continue
                local = p.to_local() if hasattr(p, "to_local") else p
                if self.spec.kind == "grad-explode":
                    local.mul_(GRAD_EXPLODE_SCALE)
                elif (path[0] != "blocks" or path[2] == 0) and _owns_first_element(model, name, p):
                    local.view(-1)[0] = BITFLIP_VALUE
        if self.spec.kind == "bitflip":
            self._announce(f"bitflip: {label}[0...] = {BITFLIP_VALUE:g} before step {step}")
        else:
            self._announce(f"grad-explode: {label} scaled x{GRAD_EXPLODE_SCALE:g} before "
                           f"step {step}")

    def corrupt_opt_state(self, step: int, optimizer) -> None:
        """Corrupt the AdamW moments in place just before step N dispatches
        (``opt-moments@N``; else nothing): every second moment
        (``exp_avg_sq``, optax's nu) scaled by :data:`MOMENT_COLLAPSE_SCALE`
        and every first moment (``exp_avg``, mu) by :data:`MOMENT_BURST_SCALE`,
        wherever the arm keeps them: ``torch.optim.AdamW``'s state (ddp,
        fsdp, zero2's shards) or the host offload's pinned buffers. Each rank
        scales the moments it holds. With no moment buffer yet the fault says
        it is inert."""
        if (self.spec is None or self.fired or self.spec.kind != "opt-moments"
                or step != self.spec.step):
            return
        self.fired = True
        adamw = optimizer.host.adamw if optimizer.host is not None else optimizer.adamw
        states = [st for st in adamw.state.values() if "exp_avg_sq" in st]
        if not states:
            self._announce("opt-moments: no Adam moment (mu/nu) buffers in this optimizer "
                           "state — fault inert")
            return
        self._announce(f"opt-moments: collapsing {len(states)} second-moment (nu) buffers "
                       f"x{MOMENT_COLLAPSE_SCALE:g} and bursting the paired mu buffers "
                       f"x{MOMENT_BURST_SCALE:g} before step {step}")
        for st in states:
            st["exp_avg_sq"].mul_(MOMENT_COLLAPSE_SCALE)
            st["exp_avg"].mul_(MOMENT_BURST_SCALE)

    def maybe_fail_save(self) -> None:
        """Raise ENOSPC from the save path for ``enospc-on-save``."""
        if self.spec is None or self.spec.kind != "enospc-on-save":
            return
        self._announce("OSError(ENOSPC) raised from checkpoint save")
        raise OSError(errno.ENOSPC, "No space left on device (injected)")

    def after_save(self, ckpt, step: int) -> None:
        """Tear the newest checkpoint and SIGKILL for ``torn-checkpoint``, once
        a committed previous step exists to fall back to."""
        if self.spec is None or self.fired or self.spec.kind != "torn-checkpoint":
            return
        steps = ckpt.all_steps()
        if len(steps) < 2:
            return
        self.fired = True
        torn = _tear_newest_file(ckpt.step_dir(max(steps)))
        self._announce(f"tore checkpoint step {max(steps)} ({torn}); SIGKILL")
        os.kill(os.getpid(), signal.SIGKILL)

    # -- data-path faults (consumed by data/stream.py and data/prefetch.py) --

    def data_missing_shard(self) -> Optional[int]:
        """Shard index to withhold from discovery (``data-missing-shard@K``),
        or None. Fires at stream construction, before any device work."""
        if self.spec is None or self.spec.kind != "data-missing-shard":
            return None
        if not self.fired:
            self.fired = True
            self._announce(f"shard {self.spec.step} withheld from discovery — the stream must "
                           "refuse loudly naming it")
        return self.spec.step

    def data_stall_sec(self, step: int) -> float:
        """Seconds the prefetch producer sleeps before the batch for step N
        (``data-stall@N[:SECS]``); 0.0 otherwise. Runs on the prefetch
        thread; the announce reaches the JSONL before the consumer starves."""
        if (self.spec is None or self.fired or self.spec.kind != "data-stall"
                or step != self.spec.step):
            return 0.0
        self.fired = True
        secs = self.spec.hang_sec or HANG_DEFAULT_SEC
        self._announce(f"input source silent for {secs:g}s before the batch for step {step}")
        return secs

    def data_corrupt_payload(self, global_index: int, payload: bytes) -> bytes:
        """Flip one byte of global record N's payload as it is read
        (``data-corrupt-record@N``; else passthrough): bit-rot without
        mutating the shard files, which the CRC check must catch."""
        if (self.spec is None or self.fired or self.spec.kind != "data-corrupt-record"
                or global_index != self.spec.step):
            return payload
        self.fired = True
        self._announce(f"flipped one payload byte of global record {global_index} (CRC must "
                       "catch it; slot heals by substitution)")
        return bytes([payload[0] ^ 0xFF]) + payload[1:]

    def data_read_delay_sec(self, global_index: int) -> float:
        """Extra per-record read latency from record N on
        (``data-slow-reader@N:MS``); 0.0 otherwise. ``fired`` gates only the
        announce: the degradation lasts for the rest of the run."""
        if (self.spec is None or self.spec.kind != "data-slow-reader"
                or global_index < (self.spec.step or 0)):
            return 0.0
        if not self.fired:
            self.fired = True
            self._announce(f"every record read from global record {self.spec.step} on takes "
                           f"+{self.spec.delay_ms:g} ms (degraded mount)")
        return (self.spec.delay_ms or 0.0) / 1000.0
