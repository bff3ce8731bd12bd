#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path (``distributed_llm_training_benchmark_framework_tpu_torch``)
and fails, printing no result, if any phase fails:

0. prints the card's name and power limit (nvidia-smi), turns TF32 off,
   builds the CUDA kernels from ``csrc/`` with nvcc and prints the build time
   and ptxas's register / spill report;
1. holds each kernel (flash forward K1, backward dq K2, backward dk/dv K3)
   against its plain PyTorch version on the card at the main path's shapes:
   (a) BH 16, S 2048, Dh 64, non-causal, dropout 0.1 (the parity row),
   (b) BH 16, S 2048, Dh 128, causal, no dropout (the flagship row), and
   (c) BH 4, S 256, Dh 64, causal with dropout;
2. times each kernel, its plain version and, as a yardstick the port never
   calls, torch's scaled_dot_product_attention (rate 0: it cannot draw the
   coordinate-hash mask) with CUDA events, median of 25 launches after 5
   warmup launches, at shapes (a) and (b);
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
   bound from the live score elements of that hop, and, as a yardstick,
   SDPA's forward on the same block at rate 0 (with the block's causal mask;
   SDPA returns a normalized output);
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

Ends with a line ``{"kernels": [...]}`` (per kernel and row: launches on the
main path, error against the plain version, times, the least time the card
could take and what bounds it), the nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``. Exits nonzero without those lines when
no CUDA device is available.
"""

from __future__ import annotations

import json
import math
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


def median_ms(fn, warmup: int = 5, reps: int = 25) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
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


def bound(kind: str, shape, peaks) -> tuple[float, str]:
    """``bound_ms`` of a flash kernel (K1-K3, bf16 outputs) at a shape."""
    BH, S, D = shape["BH"], shape["S"], shape["D"]
    live = BH * (S * (S + 1) // 2 if shape["causal"] else S * S)
    mat = BH * S * D * 2
    row = BH * S * 4
    nbytes = {"fwd": 4 * mat + row, "dq": 5 * mat + 2 * row, "dkv": 6 * mat + 2 * row}[kind]
    return bound_ms(kind, D, live, nbytes, shape["rate"], peaks)


def phase_kernels(fa, peaks):
    """Phases 1 and 2: kernel vs plain at shapes a, b, c; times at a and b."""
    results = {}
    for key, sh in SHAPES.items():
        q, k, v, do = make_inputs(sh)
        c, r, seed = sh["causal"], sh["rate"], 0x2545F491
        out, lse = fa.flash_fwd(q, k, v, c, r, seed)
        p_out, p_lse = fa.flash_forward_plain(q, k, v, c, r, seed)
        delta = fa.attention_delta(p_out, do)
        bwd = (q, k, v, do, p_lse, delta, c, r, seed)
        dq = fa.flash_bwd_dq(*bwd)
        dk, dv = fa.flash_bwd_dkv(*bwd)
        torch.cuda.synchronize()
        p_dq = fa.flash_bwd_dq_plain(*bwd)
        p_dk, p_dv = fa.flash_bwd_dkv_plain(*bwd)
        errs = {
            "out": rel_err(out, p_out), "dq": rel_err(dq, p_dq),
            "dk": rel_err(dk, p_dk), "dv": rel_err(dv, p_dv),
        }
        lse_err = max_abs(lse, p_lse)
        log(f"[1] shape ({key}) BH={sh['BH']} S={sh['S']} Dh={sh['D']} causal={c} "
            f"rate={r}: rel-Frobenius {json.dumps({n: f'{e:.2e}' for n, e in errs.items()})}"
            f", lse max abs {lse_err:.2e}, out max abs {max_abs(out, p_out):.2e}")
        for name, e in errs.items():
            assert e <= 2e-2, f"shape ({key}): {name} rel error {e} > 2e-2"
        assert lse_err <= 1e-3, f"shape ({key}): lse max abs error {lse_err} > 1e-3"
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
                res[kind]["plain_ms"] = median_ms(plain, warmup=2, reps=20)
                res[kind]["bound_ms"], res[kind]["bound_by"] = bound(kind, sh, peaks)
                res[kind]["library_ms"] = None
            # Yardstick: SDPA on the same (B=1, H=BH, S, Dh) layout, rate 0.
            qs, ks, vs = (t.unsqueeze(0).detach().requires_grad_(True) for t in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            res["fwd"]["library_ms"] = median_ms(lambda: sdpa(qs, ks, vs, is_causal=c))
            do4 = do.unsqueeze(0)
            res["fwd"]["library_fwd_bwd_ms"] = median_ms(
                lambda: torch.autograd.grad(sdpa(qs, ks, vs, is_causal=c), (qs, ks, vs), do4))
            log(f"[2] shape ({key}) times (ms, median of 25): " + json.dumps(
                {kind: {n: (round(x, 5) if isinstance(x, float) else x) for n, x in d.items()}
                 for kind, d in res.items()}))
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
                             plain_ms=median_ms(plain, warmup=2, reps=20), library_ms=None)
            res[kind]["bound_ms"], res[kind]["bound_by"] = bound_ms(
                kind, D, live, nbytes[kind], r, peaks)
        # Yardstick: SDPA forward on the same block at rate 0, with the
        # block's causal mask (every row of the timed block has a live key).
        qs, ks, vs = (t_.unsqueeze(0) for t_ in (q, k, v))
        mask = (rows[:, None] >= cols[None, :]) if c else None
        sdpa = torch.nn.functional.scaled_dot_product_attention
        res["fwd"]["library_ms"] = median_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask))
        res["fwd"]["library_note"] = ("SDPA forward, rate 0, on the same block; it returns "
                                      "a normalized output, K4 an unnormalized one")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; nothing was run", file=sys.stderr)
        return 2
    from distributed_llm_training_benchmark_framework_tpu_torch import models
    from distributed_llm_training_benchmark_framework_tpu_torch.data import SyntheticDataset
    from distributed_llm_training_benchmark_framework_tpu_torch.ops import _build
    from distributed_llm_training_benchmark_framework_tpu_torch.ops import flash_attention as fa
    from distributed_llm_training_benchmark_framework_tpu_torch.ops import ring_attention as ra
    from distributed_llm_training_benchmark_framework_tpu_torch.parallel import make_mesh
    from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark
    from distributed_llm_training_benchmark_framework_tpu_torch.utils import flops, platform

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

    timing = phase_kernels(fa, peaks)
    launches = phase_train(fa, ra, run_benchmark)
    phase_whole_model(fa, models, SyntheticDataset)
    ring_timing = phase_ring_kernels(fa, ra, peaks)
    phase_ring_vs_flash(fa, ra)
    ring_launches = phase_ring_train(fa, ra, run_benchmark)
    phase_ring_whole_model(fa, models, SyntheticDataset, make_mesh)

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
            }
            if "library_fwd_bwd_ms" in r:
                entry["library_fwd_bwd_ms"] = r["library_fwd_bwd_ms"]
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
                **{nm: r[nm] for nm in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
            }
            if "library_note" in r:
                entry["library_note"] = r["library_note"]
            kernels.append(entry)
    log(f"[10] total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
