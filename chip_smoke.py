#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path (``distributed_llm_training_benchmark_framework_tpu_torch``)
and fails, printing no result, if any phase fails:

0. prints the card's name and power limit (nvidia-smi), turns TF32 off,
   builds the CUDA kernels from ``csrc/`` with nvcc and prints the build time
   and ptxas's register / spill report, per template instance of every
   kernel (the wgmma kernels K1, K4 and K5-K9 on
   ``csrc/flash_fwd_sm90.cuh``'s mainloop and ``csrc/flash_bwd.cu``'s pair),
   with any ptxas line about wgmma;
1. holds each kernel (flash forward K1, backward dq K2, backward dk/dv K3)
   against its plain PyTorch version on the card at the main path's shapes:
   (a) BH 16, S 2048, Dh 64, non-causal, dropout 0.1 (the parity row),
   (b) BH 16, S 2048, Dh 128, causal, no dropout (the flagship row),
   (c) BH 4, S 256, Dh 64, causal with dropout, and (h) (a) with batch
   offset 3, as a data-parallel rank holds its rows: the mask keyed by
   global batch*head ids 48-63 (K1 through its offset seed, K2 and K3
   through their id vector), which must change the output;
2. times each kernel, its plain version and, as a yardstick the port never
   calls, torch's scaled_dot_product_attention (rate 0: it cannot draw the
   coordinate-hash mask) with CUDA events, median of 25 launches after 5
   warmup launches, at shapes (a) and (b). ``ms`` starts the clock on an
   idle card, so it holds the wrapper's host time up to the launch as well
   as the kernel (the clock of every ``ms`` in PERF.md); ``device_ms``
   (and ``library_device_ms`` for SDPA) queues each timed launch behind a
   ~1 ms device sleep, so it is the card's own time, and ``ms -
   device_ms`` is about the host's share. The backward pair's yardstick
   is torch's flash-attention backward (``aten.
   _scaled_dot_product_flash_attention_backward``, rate 0, dq, dk and dv
   in one call, delta computed inside; its out and logsumexp from the
   matching forward op), set beside the pair's own dq + dk/dv +
   ``attention_delta`` on both clocks. At (a), whose row drops, K1 and
   the pair are timed again at rate 0, as the library runs, for a like-for-
   like factor (``rate0_*``);
3. trains both bench rows at full tier-A width through
   ``train.loop.run_benchmark`` (parity: TinyGPT b1 x accum 4, dropout 0.1;
   flagship: Llama b2 x accum 2), 3 warmup + 10 timed steps each, and checks
   the losses fall and each kernel's launch count equals layers x
   micro-batches x steps;
4. checks that the first-step tier-A loss (dropout 0) through the kernels
   matches the loss through the plain attention within 1e-2, for both
   families.

The sequence-parallel path (ring attention over 4 sequence shards, all held
on the one card) at S 8192, full tier-A width, in two ring rows:
(d) parity ring: TinyGPT, BH 16, shards of 2048, Dh 64, non-causal, rate
0.1, contiguous; (e) flagship ring: Llama, BH 8 (b1 x 8 heads, the batch
the flagship ring row trains at), shards of 2048 as zigzag half-chunks of
1024, Dh 128, causal, rate 0.

5. holds the ring kernels (ring block forward K4, fp32-output backward dq
   K2′ and dk/dv K3′) against their plain versions at every hop of shards 0
   and 3 of 4, at (d) and (e): rel-Frobenius <= 2e-2 on o, dq, dk, dv, max
   abs <= 1e-3 on m and l;
6. times them at one hop (shard 1, hop 1) of (d) and (e) as in phase 2, the
   bound from the live score elements of that hop, and, as yardsticks at
   rate 0, SDPA's forward on the same block (with the block's causal mask;
   SDPA returns a normalized output) and, for the backward pair, at (d)
   torch's flash-attention backward as in phase 2 and at (e), whose
   zigzag mask that op cannot take, SDPA's masked forward + backward
   (``torch.autograd.grad``) less its forward; at (d) K4 and the pair
   again at rate 0, as in phase 2;
7. holds ``ring_attention`` over 4 shards against ``flash_attention`` over
   the whole S 8192 on the card: out, dq, dk, dv within rel-Frobenius 2e-2,
   both layouts, rate 0 and 0.1, same seed;
8. trains both ring rows through ``run_benchmark`` with
   ``sequence_parallel=4, attention_impl="ring"`` (parity ring: TinyGPT b1 x
   accum 1, dropout 0.1; flagship ring: Llama b1 x accum 2, causal, zigzag
   auto), 3 warmup + 10 timed steps, and checks the losses fall, K4, K2′ and
   K3′ each launched layers x micro-batches x steps x 16 times and K1-K3 not
   at all;
9. checks the first-step tier-A loss at S 8192 (dropout 0) through the ring
   against flash within 1e-2, for both families.

The head-dim-64 forward microbench (``microbench/flash_fwd.py``, the port of
``scripts/microbench_flash_fwd.py``) and its five kernels K5-K9
(``ops/fwd_variants.py``): non-causal, no dropout, at (f) BH 16, S 2048,
Dh 64 (the microbench's default, the parity row's attention block at rate
0) and (g) BH 4, S 256, Dh 128.

10. holds K5-K9 against their plain versions at (f) and (g) (rel-Frobenius
    <= 2e-2; K8, which has no softmax and so no online-rescale gap, also
    <= 2e-3), K5, K6 and K7 against K1 at rate 0 bit for bit (the four run
    the wgmma mainloop of ``csrc/flash_fwd_sm90.cuh`` with one arithmetic),
    K9 against K5 bit for bit at Dh 64 (K9 scales q in bf16 by 2^-3 there,
    which commutes with every rounding of that loop), and K8 against its
    plain version bit for bit on integer inputs in {-2, ..., 2} at (f)
    (every score, every bf16(score * 2^-3) and every fp32 sum of P.V is
    exact there, so any difference is a fault of the kernel); prints max
    |Δ| between the kernels, and times each at (f) as in phase 2, beside
    SDPA on the same block (for K8, which no one call computes, the two
    calls baddbmm and bmm, on both clocks), K5, K6, K7 and K9 also against
    K1 and K8 against K5 on the device clock (the microbench's split of one
    forward into its products and its softmax);
11. runs the microbench once through its module at (f), printing its table,
    and checks every kernel's launch count equals the launches it made.

The strategy arms (``parallel/strategies.py``) on the parity row:

12. runs one tier-A micro-batch at dropout 0.1 under remat none, dots and
    full with the same seeds and generator (gradients within 1e-5
    relative, K1 launched twice per layer under remat), then trains the
    parity row 3 warmup + 10 timed steps under each arm (ddp, fsdp, zero2,
    zero3) without a process group, and again inside a single-rank NCCL
    group made by ``runtime.setup_distributed``, where each arm lays the
    model out (DDP, FSDP2's DTensors, zero2's flat buffers; checked), and
    checks the losses fall, each step's loss under the group within 1e-3
    relative of the no-group run, and K1-K3's launch counts equal layers x
    micro-batches x steps (K1 twice that under remat); prints each arm's
    resolved remat, tokens/s, peak memory and ``world_size``. At world 1
    these measure each wrapper's cost on one card, not scaling. The group
    is torn down at the end.

Ends with a line ``{"kernels": [...]}`` (per kernel and row: launches on the
main path, error against the plain version, times, the least time the card
could take and what bounds it), the nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``. Exits nonzero without those lines when
no CUDA device is available.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time

import torch

# INT32 lanes: 64 per SM (Hopper architecture white paper) x 132 SMs x the
# 1.98 GHz maximum SM clock of the H100 SXM; the dropout hash runs on these.
# The bf16 and HBM peaks come from the package's tables (utils/flops.py,
# utils/platform.py), matched on the card's name.
H100_INT32_OPS = 64 * 132 * 1.98e9
HASH_OPS_PER_ELEMENT = 10  # mix32 (2 mul, 3 shift, 3 xor) + add + compare
# Exponentials: 16 per SM per clock (the special-function units), same SMs
# and clock. Written beside the softmax variants' bound, not part of it.
H100_EXP_OPS = 16 * 132 * 1.98e9

WARMUP_STEPS, TIMED_STEPS = 3, 10


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


# About 1 ms of device sleep (torch.cuda._sleep counts SM clock cycles).
SLEEP_CYCLES = 2_000_000


def median_ms(fn, warmup: int = 5, reps: int = 25, device_clock: bool = False) -> float:
    """Median over ``reps`` calls of the time between two CUDA events around
    one call of ``fn``. The clock starts on an idle card, so the reading
    holds the host's time from the first event to the launch as well as the
    kernel. ``device_clock=True`` enqueues each call behind a ~1 ms device
    sleep instead: the host's time is then off the clock and the reading is
    the card's own time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if device_clock:
            torch.cuda._sleep(SLEEP_CYCLES)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


SHAPES = {
    "a": dict(BH=16, S=2048, D=64, causal=False, rate=0.1, row="parity"),
    "b": dict(BH=16, S=2048, D=128, causal=True, rate=0.0, row="flagship"),
    "c": dict(BH=4, S=256, D=64, causal=True, rate=0.1, row=None),
    # (a) as rank 1 of a data-parallel pair holding 3 rows of batch each:
    # the mask keyed by global batch*head ids 48..63.
    "h": dict(BH=16, S=2048, D=64, causal=False, rate=0.1, row=None, batch_offset=3),
}


def make_inputs(shape, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    BH, S, D = shape["BH"], shape["S"], shape["D"]
    return [torch.randn(BH, S, D, device="cuda", generator=g).to(torch.bfloat16)
            for _ in range(4)]


FLOPS_PER_LIVE_ELEMENT = {"fwd": 4, "dq": 6, "dkv": 8}  # times Dh: the tile products


def bound_ms(kind: str, D: int, live: int, nbytes: int, rate: float,
             peaks) -> tuple[float, str]:
    """Least time (ms) the card could take for the work and what bounds it:
    ``nbytes`` (each input read once, each output written once) at the HBM
    rate, the live score elements' tensor FLOPs at the bf16 peak and, with
    dropout, their hash integer work at the INT32 rate."""
    t_bytes = nbytes / peaks["bytes"]
    t_ops = FLOPS_PER_LIVE_ELEMENT[kind] * D * live / peaks["flops"]
    if rate > 0:
        t_ops = max(t_ops, HASH_OPS_PER_ELEMENT * live / H100_INT32_OPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def library_flash_bwd(q, k, v, do, causal: bool):
    """The backward pair's yardstick: a thunk of one call of torch's
    flash-attention backward (``aten._scaled_dot_product_flash_attention_backward``,
    rate 0: it cannot draw the coordinate-hash mask) on the (1, BH, S, Dh)
    layout, with its out and logsumexp from the matching forward op on the
    same inputs. It returns (dq, dk, dv) and computes delta inside."""
    aten = torch.ops.aten
    q4, k4, v4, do4 = (t.unsqueeze(0) for t in (q, k, v, do))
    out, lse, cum_q, cum_k, max_q, max_k, philox_seed, philox_offset = (
        aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, causal)[:8])
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        do4, q4, k4, v4, out, lse, cum_q, cum_k, max_q, max_k, 0.0, causal, philox_seed,
        philox_offset)


def time_pair(res, fa, out, do, library) -> None:
    """Put the backward pair's yardstick on ``res``: the library call's time on
    both clocks on the dk/dv entry, beside the pair's own dq + dk/dv +
    attention_delta (the library computes delta inside); a note on dq."""
    delta_ms = median_ms(lambda: fa.attention_delta(out, do))
    delta_device_ms = median_ms(lambda: fa.attention_delta(out, do), device_clock=True)
    lib_ms, lib_device_ms, note = library
    res["dkv"].update(
        library_ms=lib_ms, library_device_ms=lib_device_ms, attention_delta_ms=delta_ms,
        attention_delta_device_ms=delta_device_ms,
        pair_ms=res["dq"]["ms"] + res["dkv"]["ms"] + delta_ms,
        pair_device_ms=res["dq"]["device_ms"] + res["dkv"]["device_ms"] + delta_device_ms,
        library_note=note)
    res["dq"]["library_note"] = ("one library call computes dq, dk and dv together: its time "
                                 "is on this row's flash_bwd_dkv entry beside the pair's")


def time_rate0(res, fwd, dq, dkv) -> None:
    """Where a row drops (rate 0.1), time its forward and backward pair again
    at rate 0 on both clocks, so that the factor against the library (which
    runs at rate 0: it cannot draw the hash) is like for like: the forward's
    on the fwd entry, the pair's (dq + dk/dv + attention_delta) on the dk/dv
    entry."""
    for kind, fn in (("fwd", fwd), ("dq", dq), ("dkv", dkv)):
        res[kind]["rate0_ms"] = median_ms(fn)
        res[kind]["rate0_device_ms"] = median_ms(fn, device_clock=True)
    res["fwd"]["rate0_library_factor"] = (res["fwd"]["rate0_device_ms"]
                                          / res["fwd"]["library_device_ms"])
    pair = (res["dq"]["rate0_device_ms"] + res["dkv"]["rate0_device_ms"]
            + res["dkv"]["attention_delta_device_ms"])
    res["dkv"]["rate0_pair_device_ms"] = pair
    res["dkv"]["rate0_pair_library_factor"] = pair / res["dkv"]["library_device_ms"]


def bound(kind: str, shape, peaks) -> tuple[float, str]:
    """``bound_ms`` of a flash kernel (K1-K3, bf16 outputs) at a shape."""
    BH, S, D = shape["BH"], shape["S"], shape["D"]
    live = BH * (S * (S + 1) // 2 if shape["causal"] else S * S)
    mat = BH * S * D * 2
    row = BH * S * 4
    nbytes = {"fwd": 4 * mat + row, "dq": 5 * mat + 2 * row, "dkv": 6 * mat + 2 * row}[kind]
    return bound_ms(kind, D, live, nbytes, shape["rate"], peaks)


# The template parameters of every kernel template in csrc/, by name: phase 0
# prints each instance's registers and spills under them. K1 / K4, K5 / K6 /
# K7 (fwd_layout_kernel), K8 (fwd_matmul_kernel) and K9 (fwd_qscaled_kernel)
# run csrc/flash_fwd_sm90.cuh's mainloop; K2 / K3 are the backward pair in
# csrc/flash_bwd.cu (None: the output type).
KERNEL_PARAMS = {
    "flash_fwd_kernel": ("Dh", "causal", "dropout"),
    "ring_fwd_block_kernel": ("Dh", "causal", "dropout"),
    "flash_bwd_dq_kernel": ("Dh", "causal", "dropout", None),
    "flash_bwd_dkv_kernel": ("Dh", "causal", "dropout", None),
    "fwd_layout_kernel": ("Dh", "k transposed", "warpgroups"),
    "fwd_qscaled_kernel": ("Dh",),
    "fwd_matmul_kernel": ("Dh",),
}
# One Itanium-mangled template argument: an int or bool literal, or a type.
TEMPLATE_ARG = re.compile(r"L[ib](\d+)E|(f)|(13__nv_bfloat16)")


def instance_name(mangled: str) -> str:
    """``kernel<Dh 64, causal 0, ...>`` for an instance of a KERNEL_PARAMS
    template; any other entry keeps its mangled name."""
    kernel = next((k for k in KERNEL_PARAMS if f"{len(k)}{k}I" in mangled), None)
    if kernel is None:
        return mangled
    head = f"{len(kernel)}{kernel}I"
    pos, args = mangled.index(head) + len(head), []
    for label in KERNEL_PARAMS[kernel]:
        m = TEMPLATE_ARG.match(mangled, pos)
        if m is None:
            return mangled
        pos = m.end()
        args.append(f"{label} {m[1]}" if m[1] is not None
                    else "fp32 out" if m[2] else "bf16 out")
    return f"{kernel}<{', '.join(args)}>"


def ptxas_instances(report: list[str]) -> dict:
    """{instance name (``instance_name``): (registers, spill line)} from ptxas -v."""
    out, name, spill = {}, None, ""
    for ln in report:
        if "Compiling entry function" in ln:
            name = instance_name(ln.split("'")[1])
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln and name is not None:
            out[name] = (int(re.search(r"Used (\d+) registers", ln)[1]), spill)
            name = None
    return out


def phase_kernels(fa, peaks):
    """Phases 1 and 2: kernel vs plain at shapes a, b, c; times at a and b."""
    results, outs = {}, {}
    for key, sh in SHAPES.items():
        q, k, v, do = make_inputs(sh)
        c, r, seed = sh["causal"], sh["rate"], 0x2545F491
        # One batch of BH heads: batch offset b keys the rows as ids b*BH + i.
        b_off = sh.get("batch_offset", 0)
        bhv = fa._global_bh_vec(1, sh["BH"], b_off, 0, sh["BH"], "cuda") if b_off else None
        out, lse = fa.flash_fwd(q, k, v, c, r, seed, b_off * sh["BH"])
        p_out, p_lse = fa.flash_forward_plain(q, k, v, c, r, seed, b_off * sh["BH"])
        outs[key] = out
        delta = fa.attention_delta(p_out, do)
        bwd = (q, k, v, do, p_lse, delta, c, r, seed)
        dq = fa.flash_bwd_dq(*bwd, bhv=bhv)
        dk, dv = fa.flash_bwd_dkv(*bwd, bhv=bhv)
        torch.cuda.synchronize()
        p_dq = fa.flash_bwd_dq_plain(*bwd, bhv=bhv)
        p_dk, p_dv = fa.flash_bwd_dkv_plain(*bwd, bhv=bhv)
        errs = {
            "out": rel_err(out, p_out), "dq": rel_err(dq, p_dq),
            "dk": rel_err(dk, p_dk), "dv": rel_err(dv, p_dv),
        }
        lse_err = max_abs(lse, p_lse)
        log(f"[1] shape ({key}) BH={sh['BH']} S={sh['S']} Dh={sh['D']} causal={c} "
            f"rate={r}{f' batch offset {b_off}' if b_off else ''}: rel-Frobenius "
            f"{json.dumps({n: f'{e:.2e}' for n, e in errs.items()})}"
            f", lse max abs {lse_err:.2e}, out max abs {max_abs(out, p_out):.2e}")
        for name, e in errs.items():
            assert e <= 2e-2, f"shape ({key}): {name} rel error {e} > 2e-2"
        assert lse_err <= 1e-3, f"shape ({key}): lse max abs error {lse_err} > 1e-3"
        if b_off:
            # Same inputs as (a): another mask must give another output.
            assert not torch.equal(out, outs["a"]), f"shape ({key}): the offset changed nothing"
        res = {
            "fwd": dict(max_abs_err=max(max_abs(out, p_out), lse_err)),
            "dq": dict(max_abs_err=max_abs(dq, p_dq)),
            "dkv": dict(max_abs_err=max(max_abs(dk, p_dk), max_abs(dv, p_dv))),
        }
        if sh["row"] is not None:
            timings = {
                "fwd": (lambda: fa.flash_fwd(q, k, v, c, r, seed),
                        lambda: fa.flash_forward_plain(q, k, v, c, r, seed)),
                "dq": (lambda: fa.flash_bwd_dq(*bwd), lambda: fa.flash_bwd_dq_plain(*bwd)),
                "dkv": (lambda: fa.flash_bwd_dkv(*bwd), lambda: fa.flash_bwd_dkv_plain(*bwd)),
            }
            for kind, (kern, plain) in timings.items():
                res[kind]["ms"] = median_ms(kern)
                res[kind]["device_ms"] = median_ms(kern, device_clock=True)
                res[kind]["plain_ms"] = median_ms(plain, warmup=2, reps=20)
                res[kind]["bound_ms"], res[kind]["bound_by"] = bound(kind, sh, peaks)
                res[kind]["library_ms"] = None
            # Yardstick: SDPA on the same (B=1, H=BH, S, Dh) layout, rate 0.
            qs, ks, vs = (t.unsqueeze(0).detach().requires_grad_(True) for t in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            res["fwd"]["library_ms"] = median_ms(lambda: sdpa(qs, ks, vs, is_causal=c))
            res["fwd"]["library_device_ms"] = median_ms(lambda: sdpa(qs, ks, vs, is_causal=c),
                                                        device_clock=True)
            do4 = do.unsqueeze(0)
            res["fwd"]["library_fwd_bwd_ms"] = median_ms(
                lambda: torch.autograd.grad(sdpa(qs, ks, vs, is_causal=c), (qs, ks, vs), do4))
            lib = library_flash_bwd(q, k, v, do, c)
            if r == 0.0:
                lib_dq, lib_dk, lib_dv = (t[0] for t in lib())
                log(f"[2] shape ({key}) library backward vs the kernels, rel-Frobenius: dq "
                    f"{rel_err(lib_dq, dq):.2e}, dk {rel_err(lib_dk, dk):.2e}, dv "
                    f"{rel_err(lib_dv, dv):.2e}")
            time_pair(res, fa, p_out, do, (
                median_ms(lib), median_ms(lib, device_clock=True),
                "torch's flash-attention backward (aten._scaled_dot_product_flash_attention_"
                "backward), rate 0, one call for dq, dk and dv; pair_ms is dq + dk/dv + "
                "attention_delta"))
            if r > 0:
                out0, lse0 = fa.flash_fwd(q, k, v, c, 0.0, seed)
                bwd0 = (q, k, v, do, lse0, fa.attention_delta(out0, do), c, 0.0, seed)
                time_rate0(res, lambda: fa.flash_fwd(q, k, v, c, 0.0, seed),
                           lambda: fa.flash_bwd_dq(*bwd0), lambda: fa.flash_bwd_dkv(*bwd0))
            log(f"[2] shape ({key}) times (ms, median of 25): " + json.dumps(
                {kind: {n: (round(x, 5) if isinstance(x, float) else x) for n, x in d.items()
                        if n != "library_note"} for kind, d in res.items()}))
            results[key] = res
        del q, k, v, do
        torch.cuda.empty_cache()
    return results


def phase_train(fa, ra, run_benchmark):
    """Phase 3: both rows at full tier-A width through run_benchmark."""
    rows = {
        "parity": dict(model_family="tinygpt", per_device_batch=1, grad_accum=4, layers=16),
        "flagship": dict(model_family="llama", per_device_batch=2, grad_accum=2, layers=16),
    }
    out = {}
    for name, row in rows.items():
        steps = WARMUP_STEPS + TIMED_STEPS
        fa.reset_launch_counts()
        res = run_benchmark(
            strategy="zero2", tier="A", seq_len=2048, model_family=row["model_family"],
            steps=steps, warmup_steps=WARMUP_STEPS, per_device_batch=row["per_device_batch"],
            grad_accum=row["grad_accum"], attention_impl="flash", sync_every=5, device="cuda",
        )
        counts = fa.launch_counts()
        want = row["layers"] * row["grad_accum"] * steps
        log(f"[3] {name}: {res.model_family} tier A b{res.per_device_batch}x{res.grad_accum} "
            f"dropout {res.dropout}: {res.tokens_per_sec:.1f} tok/s, step "
            f"{1e3 * res.mean_step_time_sec:.2f} ms, MFU {res.mfu_pct:.2f}% "
            f"({res.device_kind}), peak {res.peak_hbm_gb:.2f} GB ({res.peak_hbm_method}), "
            f"loss first {res.loss_first_window:.4f} last {res.loss_last_window:.4f}, "
            f"launches {counts} (want {want} each)")
        assert math.isfinite(res.loss_first_window) and math.isfinite(res.loss_last_window)
        assert res.loss_last_window < res.loss_first_window, f"{name}: loss did not fall"
        for kernel, n in counts.items():
            assert n == want, f"{name}: {kernel} launched {n} times, want {want}"
        assert set(ra.launch_counts().values()) == {0}, f"{name}: ring kernels ran"
        out[name] = counts
        torch.cuda.empty_cache()
    return out


def phase_whole_model(fa, models, SyntheticDataset):
    """Phase 4: first-step tier-A loss, kernels vs the plain attention."""
    for family in models.MODEL_FAMILIES:
        cfg = models.get_config(family, "A", 2048, dropout=0.0, attention_impl="flash")
        with torch.device("cuda"):
            model = models.TinyGPT(cfg)
        model.init_weights(torch.Generator(device="cuda").manual_seed(0))
        batch = SyntheticDataset(cfg.vocab_size, 2048, 4, seed=42).to_device("cuda")[:1]
        with torch.no_grad():
            _, loss_kernels = model(batch, batch)
            model.attention = fa.flash_attention_plain
            _, loss_plain = model(batch, batch)
        diff = abs(loss_kernels.item() - loss_plain.item())
        log(f"[4] {family} tier A first-step loss: kernels {loss_kernels.item():.6f}, "
            f"plain {loss_plain.item():.6f}, |diff| {diff:.2e}")
        assert math.isfinite(loss_kernels.item()) and diff <= 1e-2, f"{family}: |diff| {diff}"
        del model
        torch.cuda.empty_cache()


RING_ROWS = {
    "parity ring": dict(model_family="tinygpt", per_device_batch=1, grad_accum=1, layers=16),
    "flagship ring": dict(model_family="llama", per_device_batch=1, grad_accum=2, layers=16),
}
# The ring kernels are checked and timed at the blocks the ring rows launch:
# B is the batch the row trains at.
RING_SHAPES = {
    "d": dict(B=RING_ROWS["parity ring"]["per_device_batch"], H=16, S=8192, n=4, D=64,
              causal=False, rate=0.1, zigzag=False, row="parity ring"),
    "e": dict(B=RING_ROWS["flagship ring"]["per_device_batch"], H=8, S=8192, n=4, D=128,
              causal=True, rate=0.0, zigzag=True, row="flagship ring"),
}
RING_CHECKED_SHARDS = (0, 3)
RING_TIMED = (1, 1)  # (shard, hop) of the timed block


def ring_block_inputs(fa, ra, sh, my: int, t: int):
    """Tile bases, per-row global positions and live score elements of the
    block that shard ``my`` holds at hop ``t``."""
    n, Sl = sh["n"], sh["S"] // sh["n"]
    tiles = ra._shard_tiles(n, Sl, sh["zigzag"], "cuda")
    src = (my - t) % n
    qo, ko = tiles[my], tiles[src]
    rows = fa._tile_coords(qo, Sl, "cuda")
    cols = fa._tile_coords(ko, Sl, "cuda")
    BH = sh["B"] * sh["H"]
    live = BH * (int((rows[:, None] >= cols[None, :]).sum()) if sh["causal"] else Sl * Sl)
    return qo, ko, rows, cols, live


def phase_ring_kernels(fa, ra, peaks):
    """Phases 5 and 6: K4, K2′, K3′ vs plain at every hop of two shards, and
    their times at one hop, at ring shapes (d) and (e)."""
    results = {}
    for key, sh in RING_SHAPES.items():
        B, H, n, D = sh["B"], sh["H"], sh["n"], sh["D"]
        BH, Sl = B * H, sh["S"] // n
        q, k, v, do = make_inputs(dict(BH=BH, S=Sl, D=D), seed=1)
        c, r, seed = sh["causal"], sh["rate"], 0x2545F491
        bhv = ra._global_bh_vec(B, H, 0, 0, H, "cuda")
        errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
        worst = {"o": 0.0, "m": 0.0, "l": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
        for my in RING_CHECKED_SHARDS:
            for t in range(n):
                qo, ko, rows, cols, live = ring_block_inputs(fa, ra, sh, my, t)
                m, l, o = ra.ring_fwd_block(q, k, v, c, r, seed, qo, ko, bhv)
                pm, pl, po = ra._block_stats_plain(q, k, v, seed, rows, cols, bhv, c, r)
                l_safe = torch.where(pl == 0, 1.0, pl)
                lse = pm + torch.log(l_safe)
                delta = fa.attention_delta((po / l_safe[..., None]).to(q.dtype), do)
                bwd = (q, k, v, do, lse, delta, c, r, seed, qo, ko, bhv)
                dq = fa.flash_bwd_dq(*bwd, out_dtype=torch.float32)
                dk, dv = fa.flash_bwd_dkv(*bwd, out_dtype=torch.float32)
                torch.cuda.synchronize()
                p_dq = fa.flash_bwd_dq_plain(*bwd, out_dtype=torch.float32)
                p_dk, p_dv = fa.flash_bwd_dkv_plain(*bwd, out_dtype=torch.float32)
                hop = {"o": rel_err(o, po), "m": max_abs(m, pm), "l": max_abs(l, pl),
                       "dq": rel_err(dq, p_dq), "dk": rel_err(dk, p_dk), "dv": rel_err(dv, p_dv)}
                log(f"[5] ({key}) shard {my} hop {t} (block from shard {(my - t) % n}, "
                    f"{live / (BH * Sl * Sl):.3f} live): rel-Frobenius o/dq/dk/dv "
                    f"{hop['o']:.2e}/{hop['dq']:.2e}/{hop['dk']:.2e}/{hop['dv']:.2e}, "
                    f"max abs m {hop['m']:.2e} l {hop['l']:.2e}")
                for name in ("o", "dq", "dk", "dv"):
                    assert hop[name] <= 2e-2, f"({key}) {my}/{t}: {name} rel {hop[name]} > 2e-2"
                for name in ("m", "l"):
                    assert hop[name] <= 1e-3, f"({key}) {my}/{t}: {name} max abs {hop[name]} > 1e-3"
                worst = {name: max(worst[name], e) for name, e in hop.items()}
                errs["fwd"] = max(errs["fwd"], max_abs(o, po), hop["m"], hop["l"])
                errs["dq"] = max(errs["dq"], max_abs(dq, p_dq))
                errs["dkv"] = max(errs["dkv"], max_abs(dk, p_dk), max_abs(dv, p_dv))
        log(f"[5] ({key}) worst over shards {RING_CHECKED_SHARDS}, every hop: "
            + json.dumps({name: f"{e:.2e}" for name, e in worst.items()}))

        my, t = RING_TIMED
        qo, ko, rows, cols, live = ring_block_inputs(fa, ra, sh, my, t)
        m, l, o = ra.ring_fwd_block(q, k, v, c, r, seed, qo, ko, bhv)
        l_safe = torch.where(l == 0, 1.0, l)
        lse = m + torch.log(l_safe)
        delta = fa.attention_delta((o / l_safe[..., None]).to(q.dtype), do)
        bwd = (q, k, v, do, lse, delta, c, r, seed, qo, ko, bhv)
        f32 = torch.float32
        mat, mat32, row = BH * Sl * D * 2, BH * Sl * D * 4, BH * Sl * 4
        nbytes = {"fwd": 3 * mat + mat32 + 2 * row, "dq": 4 * mat + 2 * row + mat32,
                  "dkv": 4 * mat + 2 * row + 2 * mat32}
        timings = {
            "fwd": (lambda: ra.ring_fwd_block(q, k, v, c, r, seed, qo, ko, bhv),
                    lambda: ra._block_stats_plain(q, k, v, seed, rows, cols, bhv, c, r)),
            "dq": (lambda: fa.flash_bwd_dq(*bwd, out_dtype=f32),
                   lambda: fa.flash_bwd_dq_plain(*bwd, out_dtype=f32)),
            "dkv": (lambda: fa.flash_bwd_dkv(*bwd, out_dtype=f32),
                    lambda: fa.flash_bwd_dkv_plain(*bwd, out_dtype=f32)),
        }
        res = {}
        for kind, (kern, plain) in timings.items():
            res[kind] = dict(max_abs_err=errs[kind], ms=median_ms(kern),
                             device_ms=median_ms(kern, device_clock=True),
                             plain_ms=median_ms(plain, warmup=2, reps=20), library_ms=None)
            res[kind]["bound_ms"], res[kind]["bound_by"] = bound_ms(
                kind, D, live, nbytes[kind], r, peaks)
        # Yardstick: SDPA forward on the same block at rate 0, with the
        # block's causal mask (every row of the timed block has a live key).
        qs, ks, vs = (t_.unsqueeze(0) for t_ in (q, k, v))
        mask = (rows[:, None] >= cols[None, :]) if c else None
        sdpa = torch.nn.functional.scaled_dot_product_attention
        res["fwd"]["library_ms"] = median_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask))
        res["fwd"]["library_device_ms"] = median_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask),
                                                    device_clock=True)
        res["fwd"]["library_note"] = ("SDPA forward, rate 0, on the same block; it returns "
                                      "a normalized output, K4 an unnormalized one")
        # The backward pair's yardstick at rate 0: torch's flash-attention
        # backward where the block's mask is none (d); the flash op cannot
        # take the zigzag block's half-live mask (e), so there SDPA's masked
        # forward + backward less its forward.
        out = (o / l_safe[..., None]).to(q.dtype)
        if mask is None:
            lib = library_flash_bwd(q, k, v, do, False)
            library = (median_ms(lib), median_ms(lib, device_clock=True),
                       "torch's flash-attention backward (aten._scaled_dot_product_flash_"
                       "attention_backward), rate 0, one call for dq, dk and dv; pair_ms is "
                       "dq + dk/dv + attention_delta")
        else:
            qg, kg, vg = (t_.detach().requires_grad_(True) for t_ in (qs, ks, vs))
            do4 = do.unsqueeze(0)
            fwd = lambda: sdpa(qg, kg, vg, attn_mask=mask)  # noqa: E731
            fwd_bwd = lambda: torch.autograd.grad(sdpa(qg, kg, vg, attn_mask=mask),  # noqa: E731
                                                  (qg, kg, vg), do4)
            library = (median_ms(fwd_bwd) - median_ms(fwd),
                       median_ms(fwd_bwd, device_clock=True) - median_ms(fwd, device_clock=True),
                       "SDPA with the block's causal mask, rate 0: torch.autograd.grad of "
                       "scaled_dot_product_attention(attn_mask=mask) less that call's forward "
                       "(the flash backward op takes no mask); pair_ms is dq + dk/dv + "
                       "attention_delta")
        time_pair(res, fa, out, do, library)
        if r > 0:
            m0, l0, o0 = ra.ring_fwd_block(q, k, v, c, 0.0, seed, qo, ko, bhv)
            l0 = torch.where(l0 == 0, 1.0, l0)
            delta0 = fa.attention_delta((o0 / l0[..., None]).to(q.dtype), do)
            bwd0 = (q, k, v, do, m0 + torch.log(l0), delta0, c, 0.0, seed, qo, ko, bhv)
            time_rate0(res, lambda: ra.ring_fwd_block(q, k, v, c, 0.0, seed, qo, ko, bhv),
                       lambda: fa.flash_bwd_dq(*bwd0, out_dtype=f32),
                       lambda: fa.flash_bwd_dkv(*bwd0, out_dtype=f32))
        log(f"[6] ({key}) shard {my} hop {t}, {live / (BH * Sl * Sl):.3f} live, times (ms, "
            "median of 25): " + json.dumps(
                {kind: {nm: (round(x, 5) if isinstance(x, float) else x) for nm, x in d.items()
                        if nm != "library_note"} for kind, d in res.items()}))
        results[key] = res
        del q, k, v, do
        torch.cuda.empty_cache()
    return results


def phase_ring_vs_flash(fa, ra):
    """Phase 7: ring_attention over 4 shards against flash_attention over the
    whole sequence, forward and backward, both layouts, rate 0 and 0.1."""
    for key, sh in RING_SHAPES.items():
        B, H, S, D, c = sh["B"], sh["H"], sh["S"], sh["D"], sh["causal"]
        g = torch.Generator(device="cuda").manual_seed(2)
        q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=g).to(torch.bfloat16)
                       for _ in range(4))
        for zigzag in (False, True):
            for rate in (0.0, 0.1):
                outs = []
                for fn in (lambda a, b, d: ra.ring_attention(
                               a, b, d, causal=c, dropout_rate=rate, dropout_seed=7,
                               seq_shards=sh["n"], zigzag=zigzag),
                           lambda a, b, d: fa.flash_attention(
                               a, b, d, causal=c, dropout_rate=rate, dropout_seed=7)):
                    qq, kk, vv = (t_.detach().requires_grad_(True) for t_ in (q, k, v))
                    out = fn(qq, kk, vv)
                    outs.append((out, *torch.autograd.grad(out, (qq, kk, vv), do)))
                errs = {nm: rel_err(a, b) for nm, a, b in zip(("out", "dq", "dk", "dv"), *outs)}
                log(f"[7] ({key}) B {B} S {S} H {H} Dh {D} causal {c} "
                    f"{'zigzag' if zigzag else 'contiguous'} rate {rate}: ring vs flash "
                    "rel-Frobenius " + json.dumps({nm: f"{e:.2e}" for nm, e in errs.items()}))
                for nm, e in errs.items():
                    assert e <= 2e-2, f"({key}) zigzag={zigzag} rate={rate}: {nm} rel {e} > 2e-2"
                del outs
        del q, k, v, do
        torch.cuda.empty_cache()


def phase_ring_train(fa, ra, run_benchmark):
    """Phase 8: both ring rows through run_benchmark on the one card."""
    out = {}
    for name, row in RING_ROWS.items():
        steps = WARMUP_STEPS + TIMED_STEPS
        fa.reset_launch_counts()
        res = run_benchmark(
            strategy="zero2", tier="A", seq_len=8192, model_family=row["model_family"],
            steps=steps, warmup_steps=WARMUP_STEPS, per_device_batch=row["per_device_batch"],
            grad_accum=row["grad_accum"], attention_impl="ring", sequence_parallel=4,
            sync_every=5, device="cuda",
        )
        counts, flash_counts = ra.launch_counts(), fa.launch_counts()
        want = row["layers"] * row["grad_accum"] * steps * 16
        log(f"[8] {name}: {res.model_family} tier A S 8192 sp {res.sequence_parallel} "
            f"zigzag {res.ring_zigzag} causal {res.causal} b{res.per_device_batch}x"
            f"{res.grad_accum} dropout {res.dropout}: {res.tokens_per_sec:.1f} tok/s, step "
            f"{1e3 * res.mean_step_time_sec:.2f} ms, MFU {res.mfu_pct:.2f}% "
            f"({res.device_kind}), peak {res.peak_hbm_gb:.2f} GB ({res.peak_hbm_method}), "
            f"loss first {res.loss_first_window:.4f} last {res.loss_last_window:.4f}, "
            f"ring launches {counts} (want {want} each), flash launches {flash_counts}")
        assert math.isfinite(res.loss_first_window) and math.isfinite(res.loss_last_window)
        assert res.loss_last_window < res.loss_first_window, f"{name}: loss did not fall"
        for kernel, n in counts.items():
            assert n == want, f"{name}: {kernel} launched {n} times, want {want}"
        assert set(flash_counts.values()) == {0}, f"{name}: flash kernels ran: {flash_counts}"
        out[name] = counts
        torch.cuda.empty_cache()
    return out


def phase_ring_whole_model(fa, models, SyntheticDataset, make_mesh):
    """Phase 9: first-step tier-A loss at S 8192, ring (4 shards) vs flash."""
    for family in models.MODEL_FAMILIES:
        cfg = models.get_config(family, "A", 8192, dropout=0.0, attention_impl="ring")
        with torch.device("cuda"):
            model = models.TinyGPT(cfg, mesh=make_mesh((4,), ("seq",)))
        model.init_weights(torch.Generator(device="cuda").manual_seed(0))
        batch = SyntheticDataset(cfg.vocab_size, 8192, 4, seed=42).to_device("cuda")[:1]
        with torch.no_grad():
            _, loss_ring = model(batch, batch)
            model.attention = fa.flash_attention
            _, loss_flash = model(batch, batch)
        diff = abs(loss_ring.item() - loss_flash.item())
        log(f"[9] {family} tier A S 8192 first-step loss: ring {loss_ring.item():.6f}, "
            f"flash {loss_flash.item():.6f}, |diff| {diff:.2e}")
        assert math.isfinite(loss_ring.item()) and diff <= 1e-2, f"{family}: |diff| {diff}"
        del model
        torch.cuda.empty_cache()


FWD_SHAPES = {
    "f": dict(BH=16, S=2048, D=64),
    "g": dict(BH=4, S=256, D=128),
}
FWD_SOURCE = "distributed_llm_training_benchmark_framework_tpu_torch/csrc/fwd_variants.cu"
# Line of each Pallas kernel in scripts/microbench_flash_fwd.py.
FWD_REPLACES = {"fwd_current": 83, "fwd_headpair": 140, "fwd_kt": 199,
                "fwd_matmul_only": 258, "fwd_qscaled": 303}


def phase_fwd_variants(fa, fv, peaks):
    """Phase 10: K5-K9 against their plain versions at (f) and (g), K5, K6
    and K7 == K1 bitwise, K9 == K5 bitwise at Dh 64, K8 == its plain version
    bitwise on integer inputs, cross-variant differences, times at (f)."""
    results = {n: {"max_abs_err": 0.0} for n in fv.VARIANTS}
    for key, sh in FWD_SHAPES.items():
        BH, S, D = sh["BH"], sh["S"], sh["D"]
        q, k, v, _ = make_inputs(sh, seed=3)
        kt = k.transpose(1, 2).contiguous()
        args = {n: (q, kt, v) if n == "fwd_kt" else (q, k, v) for n in fv.VARIANTS}
        outs = {n: fv.WRAPPERS[n](*a) for n, a in args.items()}
        k1, _ = fa.flash_fwd(q, k, v, False, 0.0, 0)
        torch.cuda.synchronize()
        plains = {n: fv.PLAIN[n](*a) for n, a in args.items()}
        errs = {n: rel_err(outs[n], plains[n]) for n in fv.VARIANTS}
        cur = outs["fwd_current"]
        # K1 and K5-K9 run one wgmma mainloop (csrc/flash_fwd_sm90.cuh); K8
        # is its matmul-only instance and computes another function.
        cross = {"K5-K6": max_abs(cur, outs["fwd_headpair"]), "K5-K7": max_abs(cur, outs["fwd_kt"]),
                 "K6-K7": max_abs(outs["fwd_headpair"], outs["fwd_kt"]),
                 "K5-K9": max_abs(cur, outs["fwd_qscaled"]), "K5-K1": max_abs(cur, k1),
                 "K1-K6": max_abs(k1, outs["fwd_headpair"]), "K1-K7": max_abs(k1, outs["fwd_kt"])}
        log(f"[10] ({key}) BH={BH} S={S} Dh={D}: rel-Frobenius vs plain "
            + json.dumps({n: f"{e:.2e}" for n, e in errs.items()})
            + "; max abs between kernels " + json.dumps({n: f"{e:.2e}" for n, e in cross.items()}))
        for n, e in errs.items():
            assert e <= 2e-2, f"({key}) {n}: rel error {e} > 2e-2"
            results[n]["max_abs_err"] = max(results[n]["max_abs_err"], max_abs(outs[n], plains[n]))
        # No softmax, so no online-rescale gap: only the sums' order differs.
        assert errs["fwd_matmul_only"] <= 2e-3, \
            f"({key}) fwd_matmul_only: rel error {errs['fwd_matmul_only']} > 2e-3"
        if D == 64:
            assert torch.equal(outs["fwd_qscaled"], cur), f"({key}) K9 differs from K5 at Dh 64"
            # Integers in {-2, ..., 2}: |s| <= 256 fits bf16's 8 bits, s * 2^-3
            # is exact, and every fp32 sum of P.V (multiples of 2^-3 below
            # 2^17) is exact in any order, so the kernel must equal its plain
            # version bit for bit.
            g = torch.Generator(device="cuda").manual_seed(11)
            qi, ki, vi = (torch.randint(-2, 3, (BH, S, D), device="cuda", generator=g)
                          .to(torch.bfloat16) for _ in range(3))
            got, want = fv.fwd_matmul_only(qi, ki, vi), fv.fwd_matmul_only_plain(qi, ki, vi)
            log(f"[10] ({key}) K8 on integer inputs: max abs vs plain {max_abs(got, want):.2e}")
            assert torch.equal(got, want), f"({key}) K8 differs from its plain version on integers"
            del qi, ki, vi, got, want
        # K5, K6 and K7 are K1's loop with K1's arithmetic (K7 only reads k
        # through a transposed descriptor): K1's output bit for bit.
        for nm in ("fwd_current", "fwd_headpair", "fwd_kt"):
            assert torch.equal(outs[nm], k1), \
                f"({key}) {nm} differs from K1: max abs {max_abs(outs[nm], k1)}"
        if key == "f":
            live = BH * S * S
            bound = bound_ms("fwd", D, live, 4 * BH * S * D * 2, 0.0, peaks)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            sdpa_ms = median_ms(lambda: sdpa(q[None], k[None], v[None]))
            sdpa_device_ms = median_ms(lambda: sdpa(q[None], k[None], v[None]), device_clock=True)
            # K8 in two calls: bf16(scale * q.k^T), then its product with v.
            buf = torch.empty(BH, S, S, dtype=q.dtype, device=q.device)
            two_calls = lambda: torch.bmm(  # noqa: E731
                torch.baddbmm(buf, q, k.transpose(1, 2), beta=0.0, alpha=D ** -0.5), v)
            two_calls_ms = median_ms(two_calls)
            two_calls_device_ms = median_ms(two_calls, device_clock=True)
            for n, a in args.items():
                r = results[n]
                r["ms"] = median_ms(lambda: fv.WRAPPERS[n](*a))
                r["device_ms"] = median_ms(lambda: fv.WRAPPERS[n](*a), device_clock=True)
                r["plain_ms"] = median_ms(lambda: fv.PLAIN[n](*a), warmup=2, reps=20)
                r["bound_ms"], r["bound_by"] = bound
                if n == "fwd_matmul_only":
                    r["library_ms"] = None
                    r["library_two_calls_ms"] = two_calls_ms
                    r["library_device_ms"] = two_calls_device_ms
                    r["library_note"] = ("no one call computes K8: torch.baddbmm(beta=0, "
                                         "alpha=scale) then torch.bmm, two calls, on both "
                                         "clocks (library_two_calls_ms, library_device_ms)")
                else:
                    r["library_ms"] = sdpa_ms
                    r["library_device_ms"] = sdpa_device_ms
                    r["exp_bound_ms"] = 1e3 * live / H100_EXP_OPS
            k1_ms = median_ms(lambda: fa.flash_fwd(q, k, v, False, 0.0, 0))
            k1_device_ms = median_ms(lambda: fa.flash_fwd(q, k, v, False, 0.0, 0),
                                     device_clock=True)
            on_k1 = {"K5": "fwd_current", "K6": "fwd_headpair", "K7": "fwd_kt",
                     "K9": "fwd_qscaled"}
            for n in on_k1.values():
                results[n]["flash_fwd_device_ms"] = k1_device_ms
                results[n]["vs_flash_fwd_device"] = results[n]["device_ms"] / k1_device_ms
            # The microbench's split of one forward: its products (K8)
            # against products and softmax (K5), one design.
            k8 = results["fwd_matmul_only"]
            k8["vs_fwd_current_device"] = k8["device_ms"] / results["fwd_current"]["device_ms"]
            vs_k1 = ", ".join(f"{kn} / K1 {results[n]['vs_flash_fwd_device']:.3f}"
                              for kn, n in on_k1.items())
            log(f"[10] ({key}) K1 (flash_fwd, rate 0, non-causal, lse written; the wgmma "
                f"mainloop K5-K9 share) {k1_ms:.5f} ms (device {k1_device_ms:.5f}); "
                f"{vs_k1} on the device clock; K9 / K5 "
                f"{results['fwd_qscaled']['device_ms'] / results['fwd_current']['device_ms']:.3f}; "
                f"K8 / K5 {k8['vs_fwd_current_device']:.3f}; "
                f"SDPA {sdpa_ms:.5f} ms (device {sdpa_device_ms:.5f}); K8 as baddbmm + bmm "
                f"{two_calls_ms:.5f} ms (device {two_calls_device_ms:.5f})")
            log(f"[10] ({key}) times (ms, median of 25): " + json.dumps(
                {n: {nm: (round(x, 5) if isinstance(x, float) else x) for nm, x in r.items()
                     if nm != "library_note"} for n, r in results.items()}))
        del q, k, v, kt, outs, plains
        torch.cuda.empty_cache()
    return results


def phase_microbench(build, mb):
    """Phase 11: the microbench through its module at (f); every kernel's
    launch count equals the launches its row made."""
    sh = FWD_SHAPES["f"]
    build.reset_launch_counts()
    rows = mb.main(["--bh", str(sh["BH"]), "--seq", str(sh["S"]), "--dim", str(sh["D"]),
                    "--reps", "25", "--device", "cuda"])
    counts = dict(build.LAUNCHES)
    want = {r["kernel"]: r["launches"] for r in rows if r["kernel"]}
    log(f"[11] launches {counts} (want {want})")
    assert counts == want, f"microbench launches {counts}, want {want}"
    for r in rows:
        assert r["ms"] > 0 and math.isfinite(r["max_abs"]), r
        if r["ref"] == "sdpa_materialized":
            assert r["max_abs"] <= 2e-2, f"{r['name']}: max abs {r['max_abs']} vs sdpa_materialized"
    torch.cuda.empty_cache()
    return counts


ARMS = ("ddp", "fsdp", "zero2", "zero3")
# The parity row, trained under each arm.
ARM_ROW = dict(model_family="tinygpt", per_device_batch=1, grad_accum=4, layers=16)
# Largest relative difference allowed between a step's loss under the
# single-rank group and without a group (same seeds, same kernels).
ARM_LOSS_RTOL = 1e-3
# Remat recomputes with the same kernels on the same inputs; a recompute
# that drew another dropout mask would differ by O(1).
REMAT_GRAD_RTOL = 1e-5


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_remat(fa, models):
    """Phase 12, first part: one tier-A micro-batch of the parity model at
    dropout 0.1 under remat none, dots and full, same seeds and generator:
    equal gradients, and K1 launched once more per layer under remat."""
    cfg = models.get_config("tinygpt", "A", 2048, dropout=0.1, attention_impl="flash")
    batch = torch.randint(0, cfg.vocab_size, (1, 2048), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(5))
    grads = {}
    for remat in ("none", "dots", "full"):
        with torch.device("cuda"):
            model = models.TinyGPT(dataclasses.replace(cfg, remat=remat))
        model.init_weights(torch.Generator(device="cuda").manual_seed(0))
        fa.reset_launch_counts()
        _, loss = model(batch, batch, attn_seeds=list(range(1, 17)),
                        generator=torch.Generator(device="cuda").manual_seed(3))
        loss.backward()
        counts = fa.launch_counts()
        want = {"flash_fwd": 16 * (1 if remat == "none" else 2), "flash_bwd_dq": 16,
                "flash_bwd_dkv": 16}
        assert counts == want, f"remat {remat}: launches {counts}, want {want}"
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
        del model
    for remat in ("dots", "full"):
        worst = max(max_abs(grads[remat][n], g) for n, g in grads["none"].items())
        rel = max(rel_err(grads[remat][n], g) for n, g in grads["none"].items())
        log(f"[12] remat {remat} vs none, tier A micro-batch at dropout 0.1: gradients max abs "
            f"{worst:.2e}, worst rel-Frobenius {rel:.2e} (limit {REMAT_GRAD_RTOL}); K1 twice "
            "per layer")
        assert rel <= REMAT_GRAD_RTOL, f"remat {remat}: gradients differ from none by {rel}"
    del grads
    torch.cuda.empty_cache()


def phase_arms(fa, models, make_mesh, get_strategy, rt, memory, loop):
    """Phase 12: the four arms on the parity row, first without a process
    group, then under a single-rank NCCL group, where each arm wraps the
    model; per-step losses agree, K1-K3 launch what the arm issues."""
    import torch.distributed as dist

    run_benchmark, build_run, DATASET_SIZE = loop.run_benchmark, loop.build_run, loop.DATASET_SIZE
    phase_remat(fa, models)
    steps = WARMUP_STEPS + TIMED_STEPS
    runs = {}
    for grouped in (False, True):
        if grouped:
            assert rt.setup_distributed(num_processes=1, process_id=0, master_port=free_port())
            assert dist.is_initialized() and dist.get_backend() == "nccl"
            assert dist.get_world_size() == 1
        for arm in ARMS:
            mesh = make_mesh()
            assert (mesh.device_mesh is not None) == grouped
            cfg = models.get_config("tinygpt", "A", 2048, attention_impl="flash")
            remat = memory.resolve_auto_remat(
                cfg, get_strategy(arm), mesh, ARM_ROW["per_device_batch"], 2048,
                DATASET_SIZE, torch.cuda.get_device_name(0)).remat
            fa.reset_launch_counts()
            losses = []
            res = run_benchmark(
                strategy=arm, tier="A", seq_len=2048, model_family=ARM_ROW["model_family"],
                steps=steps, warmup_steps=WARMUP_STEPS,
                per_device_batch=ARM_ROW["per_device_batch"],
                grad_accum=ARM_ROW["grad_accum"], attention_impl="flash", sync_every=5,
                device="cuda", loss_log=losses)
            counts = fa.launch_counts()
            micro = ARM_ROW["layers"] * ARM_ROW["grad_accum"] * steps
            want = {"flash_fwd": micro * (1 if remat == "none" else 2),
                    "flash_bwd_dq": micro, "flash_bwd_dkv": micro}
            log(f"[12] {arm} {'single-rank NCCL group' if grouped else 'no group'}: remat "
                f"{remat}, world_size {res.world_size}, {res.tokens_per_sec:.1f} tok/s, step "
                f"{1e3 * res.mean_step_time_sec:.2f} ms, MFU {res.mfu_pct:.2f}%, peak "
                f"{res.peak_hbm_gb:.2f} GB ({res.peak_hbm_method}), loss first "
                f"{res.loss_first_window:.4f} last {res.loss_last_window:.4f}, launches {counts}")
            assert res.world_size == 1 and len(losses) == steps
            assert all(math.isfinite(x) for x in losses)
            assert res.loss_last_window < res.loss_first_window, f"{arm}: loss did not fall"
            assert counts == want, f"{arm}: launches {counts}, want {want}"
            runs[arm, grouped] = dict(res=res, losses=losses, remat=remat, launches=counts)
            gc.collect()
            torch.cuda.empty_cache()
        if grouped:
            # What each arm laid out under the group (no fallback to the plain model).
            for arm in ARMS:
                run = build_run(strategy=arm, tier="S", seq_len=256, device="cuda")
                inner = getattr(run.model, "module", run.model)
                kinds = {type(p).__name__ for p in inner.parameters()}
                opt = type(run.step_fn.optimizer).__name__
                log(f"[12] {arm} under the group: model {type(run.model).__name__}, params "
                    f"{sorted(kinds)}, optimizer {opt}")
                assert {"ddp": isinstance(run.model, torch.nn.parallel.DistributedDataParallel),
                        "fsdp": kinds == {"DTensor"}, "zero3": kinds == {"DTensor"},
                        "zero2": opt == "_Zero2Optimizer"}[arm], f"{arm}: not laid out"
                del run
                gc.collect()
            rt.cleanup_distributed()
            assert not dist.is_initialized()
    out = {}
    for arm in ARMS:
        plain, group = runs[arm, False], runs[arm, True]
        rel = max(abs(a - b) / abs(b) for a, b in zip(group["losses"], plain["losses"]))
        log(f"[12] {arm}: per-step loss, group vs no group, max relative difference "
            f"{rel:.2e} (limit {ARM_LOSS_RTOL}); tok/s {plain['res'].tokens_per_sec:.1f} -> "
            f"{group['res'].tokens_per_sec:.1f}, peak {plain['res'].peak_hbm_gb:.2f} -> "
            f"{group['res'].peak_hbm_gb:.2f} GB")
        assert rel <= ARM_LOSS_RTOL, f"{arm}: group vs no-group loss differs by {rel}"
        out[arm] = dict(plain=plain, group=group, loss_rel=rel)
    return out


# Keys a kernel's entry in the kernels line carries where its phase measured them.
OPTIONAL_KEYS = ("library_device_ms", "library_fwd_bwd_ms", "library_note", "attention_delta_ms",
                 "attention_delta_device_ms", "pair_ms", "pair_device_ms", "rate0_ms",
                 "rate0_device_ms", "rate0_library_factor", "rate0_pair_device_ms",
                 "rate0_pair_library_factor")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; nothing was run", file=sys.stderr)
        return 2
    from distributed_llm_training_benchmark_framework_tpu_torch import models
    from distributed_llm_training_benchmark_framework_tpu_torch.data import SyntheticDataset
    from distributed_llm_training_benchmark_framework_tpu_torch.ops import _build
    from distributed_llm_training_benchmark_framework_tpu_torch.microbench import flash_fwd as mb
    from distributed_llm_training_benchmark_framework_tpu_torch.ops import flash_attention as fa
    from distributed_llm_training_benchmark_framework_tpu_torch.ops import fwd_variants as fv
    from distributed_llm_training_benchmark_framework_tpu_torch.ops import ring_attention as ra
    from distributed_llm_training_benchmark_framework_tpu_torch.parallel import (
        get_strategy,
        make_mesh,
    )
    from distributed_llm_training_benchmark_framework_tpu_torch.runtime import distributed as rt
    from distributed_llm_training_benchmark_framework_tpu_torch.train import loop
    from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark
    from distributed_llm_training_benchmark_framework_tpu_torch.utils import flops, memory, platform

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"[0] {smi}")
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    name = torch.cuda.get_device_name(0)
    tflops, gbps = flops.device_peak_tflops(name), platform.device_peak_hbm_gbps(name)
    assert tflops and gbps, f"no bf16 / HBM peak known for {name!r}"
    peaks = {"flops": tflops * 1e12, "bytes": gbps * 1e9}
    log(f"[0] peaks for the bounds: {tflops} TFLOP/s bf16 dense, {gbps} GB/s HBM, "
        f"{H100_INT32_OPS / 1e12:.2f} T int32 op/s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    log(f"[0] kernels built in {_build.build_seconds:.1f} s into {_build.build_dir()}")
    for lib in _build.SIGNATURES:
        report = (_build.build_dir() / f"{lib}.ptxas.txt").read_text().splitlines()
        regs = [ln.split(":")[-1].strip() for ln in report if "registers" in ln]
        spills = [ln.strip() for ln in report
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        log(f"[0] {lib}: {len(regs)} kernels, {sorted(set(regs))}; spills: {spills or 'none'}")
        for inst, (nregs, spill) in ptxas_instances(report).items():
            log(f"[0]   {inst}: {nregs} registers, {spill}")
        for ln in report:
            if "wgmma" in ln.lower() and "Compiling entry function" not in ln:
                log(f"[0]   ptxas: {ln.strip()}")

    timing = phase_kernels(fa, peaks)
    launches = phase_train(fa, ra, run_benchmark)
    phase_whole_model(fa, models, SyntheticDataset)
    ring_timing = phase_ring_kernels(fa, ra, peaks)
    phase_ring_vs_flash(fa, ra)
    ring_launches = phase_ring_train(fa, ra, run_benchmark)
    phase_ring_whole_model(fa, models, SyntheticDataset, make_mesh)
    fwd_timing = phase_fwd_variants(fa, fv, peaks)
    mb_launches = phase_microbench(_build, mb)
    arms = phase_arms(fa, models, make_mesh, get_strategy, rt, memory, loop)

    names = {"fwd": "flash_fwd", "dq": "flash_bwd_dq", "dkv": "flash_bwd_dkv"}
    sources = {
        "fwd": ("distributed_llm_training_benchmark_framework_tpu_torch/csrc/flash_fwd.cu",
                "distributed_llm_training_benchmark_framework_tpu/ops/flash_attention.py:127"),
        "dq": ("distributed_llm_training_benchmark_framework_tpu_torch/csrc/flash_bwd.cu",
               "distributed_llm_training_benchmark_framework_tpu/ops/flash_attention.py:328"),
        "dkv": ("distributed_llm_training_benchmark_framework_tpu_torch/csrc/flash_bwd.cu",
                "distributed_llm_training_benchmark_framework_tpu/ops/flash_attention.py:396"),
    }
    kernels = []
    for key in ("a", "b"):
        sh = SHAPES[key]
        for kind in ("fwd", "dq", "dkv"):
            r = timing[key][kind]
            entry = {
                "name": f"{names[kind]} [{sh['row']}: BH {sh['BH']} S {sh['S']} Dh {sh['D']}"
                        f" causal {sh['causal']} rate {sh['rate']}]",
                "route": "cuda",
                "source": sources[kind][0],
                "replaces": sources[kind][1],
                "launches": launches[sh["row"]][names[kind]],
                "max_abs_err": r["max_abs_err"],
                "ms": r["ms"],
                "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "device_ms": r["device_ms"],
            }
            entry.update({nm: r[nm] for nm in OPTIONAL_KEYS if nm in r})
            kernels.append(entry)
    ring_kernels = {
        "fwd": ("ring_fwd_block", "ring_fwd_block",
                "distributed_llm_training_benchmark_framework_tpu_torch/csrc/ring_fwd.cu",
                "distributed_llm_training_benchmark_framework_tpu/ops/ring_attention.py:77"),
        "dq": ("flash_bwd_dq fp32 (ring)", "flash_bwd_dq_ring", sources["dq"][0],
               "distributed_llm_training_benchmark_framework_tpu/ops/ring_attention.py:231"),
        "dkv": ("flash_bwd_dkv fp32 (ring)", "flash_bwd_dkv_ring", sources["dkv"][0],
                "distributed_llm_training_benchmark_framework_tpu/ops/ring_attention.py:252"),
    }
    for key, sh in RING_SHAPES.items():
        layout = "zigzag" if sh["zigzag"] else "contiguous"
        for kind, (label, count, source, replaces) in ring_kernels.items():
            r = ring_timing[key][kind]
            entry = {
                "name": f"{label} [{sh['row']}: BH {sh['B'] * sh['H']} Sl {sh['S'] // sh['n']}"
                        f" Dh {sh['D']} causal {sh['causal']} rate {sh['rate']} {layout},"
                        f" shard {RING_TIMED[0]} hop {RING_TIMED[1]}]",
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": ring_launches[sh["row"]][count],
                **{nm: r[nm] for nm in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms")},
            }
            entry.update({nm: r[nm] for nm in OPTIONAL_KEYS if nm in r})
            kernels.append(entry)
    sh = FWD_SHAPES["f"]
    for n in fv.VARIANTS:
        r = fwd_timing[n]
        kernels.append({
            "name": f"{n} [microbench (f): BH {sh['BH']} S {sh['S']} Dh {sh['D']} non-causal"
                    " rate 0]",
            "route": "cuda",
            "source": FWD_SOURCE,
            "replaces": f"scripts/microbench_flash_fwd.py:{FWD_REPLACES[n]}",
            "launches": mb_launches[n],
            "launches_on": "the microbench path (phase 11)",
            **r,
        })
    log("[12] the arms at world 1 (parity row; tokens/s measure each wrapper's overhead on "
        "one card, nothing about scaling): " + json.dumps({
            arm: {"remat": a["group"]["remat"], "world_size": a["group"]["res"].world_size,
                  "tokens_per_sec_no_group": a["plain"]["res"].tokens_per_sec,
                  "tokens_per_sec_group": a["group"]["res"].tokens_per_sec,
                  "peak_gb_no_group": a["plain"]["res"].peak_hbm_gb,
                  "peak_gb_group": a["group"]["res"].peak_hbm_gb,
                  "loss_max_rel_diff": a["loss_rel"], "launches_group": a["group"]["launches"]}
            for arm, a in arms.items()}) + f" on {smi}")
    log(f"[13] total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
