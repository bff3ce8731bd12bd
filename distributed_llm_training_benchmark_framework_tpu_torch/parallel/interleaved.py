"""Interleaved 1F1B: virtual pipeline stages that shrink the bubble.

Port of ``distributed_llm_training_benchmark_framework_tpu/parallel/interleaved.py``
(``Schedule``, ``build_schedule``, ``layer_permutation``: the port's own
copy, plain numpy, table for table JAX's; and the executor of
``interleaved_loss_and_grads``). Each stage d owns V non-contiguous chunks
of L/(P*V) layers: global pipeline position j in [0, P*V) is stage j % P,
chunk j // P, so a microbatch rides the ring V times through chunks 1/V the
size. A greedy list scheduler simulates the run, one unit per stage per
tick and one tick per hop, and emits per-(tick, stage) tables: which
(microbatch, chunk) to run, which buffer slots to read and write, what to
send. Position P*V - 1 has no forward unit: its backward (the "head" unit)
takes the arriving activation, runs the chunk, the head and the loss, and
back-propagates all of it in one go.

The executor (``run_interleaved``) walks this stage's column of the
tables: arriving messages park in the slots ``park_f`` / ``park_b`` name;
an F unit reads ``f_src`` (-2: embed the tokens), keeps its input in slot
``resid_rw`` and runs the chunk without a graph; a B unit reads its
gradient from ``b_src`` and its input from ``resid_rw`` and runs the chunk
again (the same masks) before back-propagating, or, at the head, reads
the activation from ``b_src``; ``send_f`` / ``send_b`` say what goes on
which ring. The slots are the scheduler's smallest-free-slot allocation,
so the live inputs and messages are bounded by O(P*V), whatever M is.
With experts, F units and the head unit add their chunk's aux, and every
B unit seeds its gradient ``router_aux_coef / (n_layer * M)``, as gpipe
and 1f1b do per stage.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import pipeline
from .pipeline import StageUnit, _backward

IDLE, FWD, BWD = 0, 1, 2  # unit kinds (the message directions are pipeline.FWD / BWD)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Static interleaved-1F1B schedule for (P stages, V chunks, M micro).

    All tables are (T, P) int32; -1 means "not applicable this tick".
    """

    P: int
    V: int
    M: int
    ticks: int
    kind: np.ndarray          # IDLE/FWD/BWD
    unit_m: np.ndarray        # microbatch index of this tick's unit
    unit_v: np.ndarray        # chunk index of this tick's unit
    f_src: np.ndarray         # FWD: pend_f slot to read (-2 = embed injection)
    b_src: np.ndarray         # BWD: pend_b slot (b_head=0) / pend_f slot (=1)
    b_head: np.ndarray        # 1 iff this BWD unit is the last position
    resid_rw: np.ndarray      # FWD: slot to write x_in / BWD: slot to read
    park_f: np.ndarray        # slot to park the arriving fwd message (-1 none)
    park_b: np.ndarray        # slot to park the arriving bwd message (-1 none)
    send_f: np.ndarray        # 1 iff this tick's F output goes on the fwd ring
    send_b: np.ndarray        # 1 iff this tick's B output goes on the bwd ring
    pend_f_slots: int
    pend_b_slots: int
    resid_slots: int

    @property
    def bubble_fraction(self) -> float:
        """Idle fraction of the schedule (unit-ticks wasted / total)."""
        work = self.M * (self.P * self.V - 1) + self.M * self.P * self.V
        return 1.0 - work / float(self.ticks * self.P)


def build_schedule(P: int, V: int, M: int) -> Schedule:
    """Greedy lockstep list-scheduler (the 'alternate' policy).

    Per tick each device picks one ready unit: after a backward it prefers a
    forward (the 1F1B steady-state alternation — strict backward-greedy
    measures 1-14 ticks worse at P=4); forwards prefer the DEEPEST ready
    position (drain in-flight microbatches before injecting new ones, which
    bounds residual liveness), backwards the oldest microbatch.

    Readiness: F(m,0) is always ready (embed is local); F(m,j) one tick after
    F(m,j-1) ran on the previous ring device. Position PV-1 has NO forward
    unit — B(m, PV-1) becomes ready one tick after F(m, PV-2) (its input has
    arrived) and does loss + chunk vjp in place; B(m,j) one tick after
    B(m,j+1).
    """
    PV = P * V
    fwd_done: Dict[Tuple[int, int], int] = {}
    bwd_done: Dict[Tuple[int, int], int] = {}
    last_was_b = [False] * P

    rows: List[dict] = []  # per tick: {d: (kind, m, j)}
    t = 0
    while len(bwd_done) < M * PV:
        if t > 8 * (2 * M * V + 4 * PV) + 64:
            raise RuntimeError(
                f"interleaved schedule did not converge (P={P}, V={V}, M={M})"
            )
        sel = {}
        for d in range(P):
            fcands, bcands = [], []
            for m in range(M):
                for v in range(V):
                    j = v * P + d
                    if j != PV - 1 and (m, j) not in fwd_done:
                        if j == 0:
                            fcands.append((m, j))
                        else:
                            pm = fwd_done.get((m, j - 1))
                            if pm is not None and pm + 1 <= t:
                                fcands.append((m, j))
                    if (m, j) not in bwd_done:
                        if j == PV - 1:
                            pm = fwd_done.get((m, j - 1))
                            if pm is not None and pm + 1 <= t:
                                bcands.append((m, j))
                        elif (m, j) in fwd_done:
                            nb = bwd_done.get((m, j + 1))
                            if nb is not None and nb + 1 <= t:
                                bcands.append((m, j))
            fcands.sort(key=lambda mj: (-mj[1], mj[0]))
            bcands.sort(key=lambda mj: (mj[0], -mj[1]))
            if last_was_b[d] and fcands:
                sel[d] = (FWD, *fcands[0])
            elif bcands:
                sel[d] = (BWD, *bcands[0])
            elif fcands:
                sel[d] = (FWD, *fcands[0])
        for d, (kind, m, j) in sel.items():
            if kind == FWD:
                fwd_done[(m, j)] = t
                last_was_b[d] = False
            else:
                bwd_done[(m, j)] = t
                last_was_b[d] = True
        rows.append(sel)
        t += 1
    T = t

    # --- second pass: buffer-slot allocation from the committed schedule ---
    shape = (T, P)
    kind = np.zeros(shape, np.int32)
    unit_m = np.full(shape, -1, np.int32)
    unit_v = np.full(shape, -1, np.int32)
    f_src = np.full(shape, -1, np.int32)
    b_src = np.full(shape, -1, np.int32)
    b_head = np.zeros(shape, np.int32)
    resid_rw = np.full(shape, -1, np.int32)
    park_f = np.full(shape, -1, np.int32)
    park_b = np.full(shape, -1, np.int32)
    send_f = np.zeros(shape, np.int32)
    send_b = np.zeros(shape, np.int32)

    # Smallest-free-slot allocation so the high-watermark equals the true
    # max concurrency (the buffer-size claim tests assert O(P*V)).
    pend_f_free = [list(range(4 * PV + 4)) for _ in range(P)]
    pend_b_free = [list(range(4 * PV + 4)) for _ in range(P)]
    resid_free = [list(range(4 * PV + 4)) for _ in range(P)]
    pend_f_of: Dict[Tuple[int, int], int] = {}  # (m, j-consumer) -> slot
    pend_b_of: Dict[Tuple[int, int], int] = {}
    resid_of: Dict[Tuple[int, int], int] = {}
    hi_f = hi_b = hi_r = 0

    for t, sel in enumerate(rows):
        # arrivals first: a message sent at t-1 parks at t (possibly consumed
        # later the same tick).
        if t > 0:
            for d, (k, m, j) in rows[t - 1].items():
                if k == FWD:  # every scheduled F unit sends (PV-1 has none)
                    dst = (d + 1) % P
                    slot = heapq.heappop(pend_f_free[dst])
                    hi_f = max(hi_f, slot + 1)
                    pend_f_of[(m, j + 1)] = slot
                    park_f[t, dst] = slot
                elif k == BWD and j != 0:
                    dst = (d - 1) % P
                    slot = heapq.heappop(pend_b_free[dst])
                    hi_b = max(hi_b, slot + 1)
                    pend_b_of[(m, j - 1)] = slot
                    park_b[t, dst] = slot
        for d, (k, m, j) in sel.items():
            kind[t, d] = k
            unit_m[t, d] = m
            unit_v[t, d] = j // P
            if k == FWD:
                if j == 0:
                    f_src[t, d] = -2
                else:
                    slot = pend_f_of.pop((m, j))
                    f_src[t, d] = slot
                    heapq.heappush(pend_f_free[d], slot)
                rslot = heapq.heappop(resid_free[d])
                hi_r = max(hi_r, rslot + 1)
                resid_of[(m, j)] = rslot
                resid_rw[t, d] = rslot
                send_f[t, d] = 1
            elif j == PV - 1:
                # Head unit: consumes the parked incoming activation directly
                # (no residual, no F unit existed for this position).
                slot = pend_f_of.pop((m, j))
                b_src[t, d] = slot
                b_head[t, d] = 1
                heapq.heappush(pend_f_free[d], slot)
                send_b[t, d] = 1
            else:
                slot = pend_b_of.pop((m, j))
                b_src[t, d] = slot
                heapq.heappush(pend_b_free[d], slot)
                rslot = resid_of.pop((m, j))
                resid_rw[t, d] = rslot
                heapq.heappush(resid_free[d], rslot)
                send_b[t, d] = int(j != 0)

    return Schedule(
        P=P, V=V, M=M, ticks=T, kind=kind, unit_m=unit_m, unit_v=unit_v,
        f_src=f_src, b_src=b_src, b_head=b_head, resid_rw=resid_rw,
        park_f=park_f, park_b=park_b, send_f=send_f, send_b=send_b,
        pend_f_slots=max(hi_f, 1), pend_b_slots=max(hi_b, 1),
        resid_slots=max(hi_r, 1),
    )


def layer_permutation(n_layer: int, P: int, V: int) -> np.ndarray:
    """perm such that stacked row r holds global layer perm[r] when the stack
    is contiguously sharded over 'pipe': device d's rows (v*Lc + i within its
    shard) hold chunk (v*P + d)'s layers."""
    if n_layer % (P * V) != 0:
        raise ValueError(
            f"n_layer={n_layer} not divisible by pipe*virtual={P}*{V}"
        )
    Lc = n_layer // (P * V)
    perm = np.empty(n_layer, np.int64)
    for d in range(P):
        for v in range(V):
            for i in range(Lc):
                r = d * (n_layer // P) + v * Lc + i
                perm[r] = (v * P + d) * Lc + i
    return perm


def run_interleaved(pipe: "pipeline.Pipeline", call, optimizer, batch: torch.Tensor, stream,
                    mask_seeds, aux_ct: float, n_blocks: int):
    """One step of the interleaved schedule on stage ``pipe.stage``
    (``Pipeline.run`` says what the arguments are) -> (the sum of the
    microbatches' mean losses on the stage holding the head, else zero;
    the summed aux or None)."""
    tab, d, P, M = pipe.tables, pipe.stage, pipe.stages, pipe.microbatches
    lc = n_blocks // tab.V
    dev = batch.device
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    aux_sum = None
    # The tick of each chunk's last backward unit on this stage.
    last_b = {int(tab.unit_v[t, d]): t for t in range(tab.ticks) if tab.kind[t, d] == BWD}
    pend_f: Dict[int, torch.Tensor] = {}
    pend_b: Dict[int, torch.Tensor] = {}
    resid: Dict[int, torch.Tensor] = {}
    inbox: Dict[int, "pipeline._Inbound"] = {}
    for t in range(tab.ticks):
        if tab.park_f[t, d] >= 0:
            pend_f[int(tab.park_f[t, d])] = inbox[pipeline.FWD].get()
        if tab.park_b[t, d] >= 0:
            pend_b[int(tab.park_b[t, d])] = inbox[pipeline.BWD].get()
        kind, m, v = int(tab.kind[t, d]), int(tab.unit_m[t, d]), int(tab.unit_v[t, d])
        sends = []
        if kind == FWD:
            embed = tab.f_src[t, d] == -2
            x = batch[m] if embed else pend_f.pop(int(tab.f_src[t, d]))
            resid[int(tab.resid_rw[t, d])] = x
            with torch.no_grad():
                y, aux = call(x, None, StageUnit(v, bool(embed), False, mask_seeds[m]), m)
            if aux is not None:
                aux_sum = aux if aux_sum is None else aux_sum + aux
            sends.append((pipeline.FWD, y))
        elif kind == BWD:
            if last_b[v] == t:
                optimizer.last_backward(f"blocks.{i}" for i in range(v * lc, (v + 1) * lc))
            head = bool(tab.b_head[t, d])
            if head:
                x = pend_f.pop(int(tab.b_src[t, d])).requires_grad_()
                loss, aux = call(x, batch[m], StageUnit(v, False, True, mask_seeds[m]), m)
                loss_sum += loss.detach()
                if aux is not None:
                    aux_sum = aux.detach() if aux_sum is None else aux_sum + aux.detach()
                out, g = loss, torch.full_like(loss, 1.0 / M)
            else:
                g = pend_b.pop(int(tab.b_src[t, d]))
                x = resid.pop(int(tab.resid_rw[t, d]))
                embed = v * P + d == 0
                if not embed:
                    x = x.requires_grad_()
                out, aux = call(x, None, StageUnit(v, embed, False, mask_seeds[m]), m)
            _backward([out, aux], [g, None if aux is None else torch.full_like(aux, aux_ct)])
            if tab.send_b[t, d]:
                sends.append((pipeline.BWD, x.grad))
        recvs = []
        if t + 1 < tab.ticks and tab.park_f[t + 1, d] >= 0:
            recvs.append((pipeline.FWD, *stream))
        if t + 1 < tab.ticks and tab.park_b[t + 1, d] >= 0:
            recvs.append((pipeline.BWD, *stream))
        inbox = pipe.transport.post(sends, recvs)
    return loss_sum, aux_sum
