"""Headline benchmark of the port: the parity row plus the flagship llama row.

    python -m distributed_llm_training_benchmark_framework_tpu_torch.bench [--strategy ARM] ...
    torchrun --nproc_per_node N -m distributed_llm_training_benchmark_framework_tpu_torch.bench ...

Prints exactly ONE JSON line on stdout (rank 0), the contract of the
repo-root ``bench.py``: ``metric`` (``{family}_tier{T}_seq{S}_tokens_per_sec_per_chip``),
``value``, ``unit``, ``vs_baseline`` (against the reference's best published
per-GPU throughput, DeepSpeed ZeRO-2 on 4x A10: 18,147 / 4 = 4,536.75
tokens/s/GPU), the visibility keys ``attention_impl``, ``dropout``,
``mfu_pct``, ``peak_hbm_gb``, ``peak_hbm_method``, ``device_kind``, the
flight recorder's ``wall_time_total_sec``, ``time_in_compile_sec`` (the
first step up to its fence, the lazy ``nvcc`` build of the kernels
included), ``time_in_timed_sec`` and ``n_anomalies`` (NaN-loss and
step-time-spike events), and a ``"flagship"`` sub-object: the llama family at per-device batch 2 x
grad-accum 2 with flash attention and its native dropout 0. Progress goes
to stderr.

The flags are the JAX bench's (``bench.py:250-266``) that have a consumer
here, with its defaults: ``--strategy`` (zero2), ``--per-device-batch`` (1),
``--grad-accum`` (4), ``--world-size`` (the process group's size: one card
per process, 1 without a launcher; another value is refused),
``--model-family``, ``--flagship auto|on|off`` (auto: the flagship row
runs when the top row is tinygpt), ``--attention``, ``--dropout`` (the
family's own by default), ``--sync-every`` and ``--tp-collective-matmul``
(the tensor-parallel projections as collective matmuls: inert without a
``model`` axis, and stamped on both rows when given, as JAX's bench does).
Like the JAX bench, it has no parameter-dtype or host-offload flag (those
arms run through ``run_benchmark``'s strategy) and no sequence- or
tensor-parallel width flag, so
``--attention ulysses`` runs at ``seq`` width 1, where Ulysses is flash
attention bit for bit, and every run is at ``model`` width 1. The flagship
row pins flash, the family's dropout and its b2 x accum 2, under the same
strategy. Under a launcher (torchrun's
``WORLD_SIZE``, or the JAX package's ``NUM_PROCESSES``) the bench joins the
process group (``runtime.setup_distributed``: NCCL, or gloo with
``--device cpu``) and every arm lays its model out over it.

``--regress auto|on|off`` and ``--registry`` are JAX's (``bench.py:313-322``):
after the line is printed, the rows are recorded in the port's registry
(``regress.store``: ``results/registry_torch``, or
``$REGRESS_REGISTRY_TORCH``, or ``--registry``) with a one-line verdict
against the last known good, on stderr and best-effort; ``auto`` (the
default) records only when that registry exists, so a default run writes
nothing. Each record carries the row's ``device_kind`` and ``backend``.

``--profile-dir DIR`` is JAX's (``bench.py:297-300``): the top row traces its
timed window with ``torch.profiler`` into DIR and the flagship row into
``DIR_flagship``, and each profiled row carries its step anatomy
(``anatomy_compute_frac``, ``comms_exposed_frac``, ``comms_overlap_frac``,
``anatomy_idle_frac``, ``bubble_frac`` and the roofline percentages, the
non-null ones). Every row carries its memory anatomy in JAX's keys and
order (``hbm_estimate_gib``, ``hbm_measured``, ``hbm_measured_reason``,
``hbm_attribution``, ``hbm_attribution_source``, ``hbm_reference_gib``,
``hbm_model_drift_frac``): the estimate against the allocator's peak on
the card, the estimate alone on the CPU.

Runs on the CUDA device unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it fails rather than fall back.

Before any arm, as JAX's (``bench.py:38-70,354-355``), it runs the graftcheck
preflight (``analysis.static``: ``--lint --audit --arms llama-tp2-gqa``, the
port's lint and the collective audit of the arm that guards the GQA layout,
on the CPU in a child process, about ten seconds) with its output on stderr,
and on a finding exits 2 before printing anything on stdout;
``--skip-preflight`` skips it.

``--remat-sweep`` is JAX's (``bench.py:81-84,344-347,418-436``): the flagship
configuration once more per remat policy of ``REMAT_SWEEP_POLICIES``, in an
additive ``remat_sweep`` sub-object keyed by the requested policy; each row
carries ``remat_policy`` (requested), ``remat_policy_resolved`` (what ran:
``auto`` resolves by the memory model, ``utils/memory.resolve_auto_remat``)
and ``hbm_headroom_gb`` (the card's capacity less the measured peak; None
on the CPU), and becomes a registry record of its own lineage
(``bench.py:remat-sweep:<policy>``), from which ``analysis.make_report``
renders the frontier. ``--layer-loop`` is JAX's (``bench.py:287``, default
``unrolled``): the top row's layer loop (``scan``: the block leaves stacked,
``models/tinygpt.ScanBlocks``); the flagship and the sweep keep
``FLAGSHIP_LAYER_LOOP``. ``tokens_per_dollar`` is JAX's key, null where the
repo holds no price for the device (the H100: ``utils/flops.py``). Checkpoints, fault injection and the
rest of the run-time flags are the harness's
(``python -m distributed_llm_training_benchmark_framework_tpu_torch.train.harness``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

from .models import MODEL_FAMILIES
from .parallel.strategies import STRATEGIES, get_strategy
from .runtime import distributed as dist_rt
from .train.loop import run_benchmark
from .utils import memory as memory_mod

REFERENCE_BEST_TOKENS_PER_SEC_PER_GPU = 18147.0 / 4

FLAGSHIP_FAMILY = "llama"
FLAGSHIP_PER_DEVICE_BATCH = 2
FLAGSHIP_GRAD_ACCUM = 2
FLAGSHIP_LAYER_LOOP = "unrolled"  # JAX's flagship loop

# The remat/HBM frontier (--remat-sweep), JAX's: every policy the model
# takes (models/tinygpt.normalize_remat) and 'auto', from no recompute to
# full recompute.
REMAT_SWEEP_POLICIES = ("none", "dots", "full", "auto")

# The graftcheck preflight's scope (JAX's): the lint rules plus the
# collective audit of the arm whose budget guards the GQA layout. The whole
# roster runs in the tests and in scripts/torch_graftcheck.sh.
PREFLIGHT_ARGS = ("--lint", "--audit", "--arms", "llama-tp2-gqa")


def run_preflight() -> None:
    """Run graftcheck in a child process (the audit plays a fake process
    group of its own, on the CPU) with its output on stderr; refuse to
    launch the arms on a finding (exit 2)."""
    proc = subprocess.run(
        [sys.executable, "-m",
         "distributed_llm_training_benchmark_framework_tpu_torch.analysis.static",
         *PREFLIGHT_ARGS],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True,
    )
    sys.stderr.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        print(
            "bench.py: graftcheck preflight FAILED (see above) — refusing "
            "to launch benchmark arms. Fix the findings, or rerun with "
            "--skip-preflight to measure anyway.",
            file=sys.stderr,
        )
        sys.exit(2)


def measure_row(args, *, model_family: str, per_device_batch: int, grad_accum: int,
                attention_impl: str, dropout, profile_dir=None, remat=None,
                layer_loop: str = FLAGSHIP_LAYER_LOOP):
    """Run one arm (``remat``: the strategy's remat policy replaced, for the
    sweep) under ``layer_loop``; return its contract-shaped row and the
    result row it was made from."""
    strategy = (args.strategy if remat is None
                else dataclasses.replace(get_strategy(args.strategy), remat=remat))
    with contextlib.redirect_stdout(sys.stderr):
        result = run_benchmark(
            strategy=strategy, tier=args.tier, seq_len=args.seq_len,
            model_family=model_family, steps=args.steps, warmup_steps=args.warmup_steps,
            per_device_batch=per_device_batch, grad_accum=grad_accum,
            attention_impl=attention_impl, dropout=dropout, sync_every=args.sync_every,
            device=args.device, world_size=args.world_size,
            tp_collective_matmul=args.tp_collective_matmul, profile_dir=profile_dir,
            layer_loop=layer_loop,
        )
    per_chip = result.tokens_per_sec / result.world_size
    extra = {"tp_collective_matmul": True} if result.tp_collective_matmul else {}
    if result.comms_exposed_frac is not None:
        # The step anatomy, only on a profiled row (JAX's bench.py:159-174).
        extra.update({k: getattr(result, k) for k in (
            "anatomy_compute_frac", "comms_exposed_frac", "comms_overlap_frac",
            "anatomy_idle_frac", "bubble_frac", "roofline_flops_pct_of_peak",
            "roofline_hbm_pct_of_peak") if getattr(result, k) is not None})
    if result.hbm_attribution is not None:
        # The memory anatomy (JAX's bench.py:186-199).
        extra.update({
            "hbm_estimate_gib": (result.hbm_estimate or {}).get("total_gib"),
            "hbm_measured": result.hbm_measured,
            "hbm_measured_reason": result.hbm_measured_reason,
            "hbm_attribution": result.hbm_attribution,
            "hbm_attribution_source": result.hbm_attribution_source,
            "hbm_reference_gib": result.hbm_reference_gib,
            "hbm_model_drift_frac": result.hbm_model_drift_frac,
        })
    if remat is not None:
        # The sweep's provenance (JAX's bench.py:199-212): the requested
        # policy keys the registry lineage, the resolved one is what ran.
        cap = memory_mod.device_hbm_bytes(result.device_kind)
        extra.update({
            "remat_policy": remat,
            "remat_policy_resolved": result.remat_policy,
            "hbm_headroom_gb": round(cap / 2**30 - result.peak_hbm_gb, 2) if cap else None,
        })
    return result, {
        "metric": f"{model_family}_tier{args.tier}_seq{args.seq_len}_tokens_per_sec_per_chip",
        "value": round(per_chip, 2),
        "unit": "tokens/sec/chip",
        "vs_baseline": round(per_chip / REFERENCE_BEST_TOKENS_PER_SEC_PER_GPU, 3),
        "attention_impl": result.attention_impl,
        "dropout": result.dropout,
        "model_tflops_per_sec_per_chip": round(result.model_tflops_per_sec_per_chip, 2),
        "mfu_pct": round(result.mfu_pct, 2),
        "peak_hbm_gb": round(result.peak_hbm_gb, 2),
        "peak_hbm_method": result.peak_hbm_method,
        "tokens_per_dollar": (round(result.tokens_per_dollar) if result.tokens_per_dollar
                              else None),
        "device_kind": result.device_kind,
        "mean_step_time_sec": round(result.mean_step_time_sec, 5),
        "loss_first_window": round(result.loss_first_window, 4),
        "loss_last_window": round(result.loss_last_window, 4),
        "wall_time_total_sec": round(result.wall_time_total_sec, 2),
        "time_in_compile_sec": round(result.time_in_compile_sec, 2),
        "time_in_timed_sec": round(result.time_in_timed_sec, 2),
        "n_anomalies": result.n_anomalies,
        **extra,
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m distributed_llm_training_benchmark_framework_tpu_torch.bench")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--tier", default="A")
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--warmup-steps", type=int, default=5)
    p.add_argument("--strategy", default="zero2", choices=sorted(STRATEGIES))
    p.add_argument("--per-device-batch", type=int, default=1)
    p.add_argument("--grad-accum", type=int, default=4)
    p.add_argument("--world-size", type=int, default=None,
                   help="default: the process group's size (1 without a launcher)")
    p.add_argument("--model-family", default="tinygpt", choices=list(MODEL_FAMILIES))
    p.add_argument("--flagship", default="auto", choices=["auto", "on", "off"])
    p.add_argument("--attention", default="flash",
                   choices=["reference", "flash", "ring", "ulysses"])
    p.add_argument("--dropout", type=float, default=None)
    p.add_argument("--sync-every", type=int, default=10)
    p.add_argument("--layer-loop", default="unrolled", choices=["scan", "unrolled"],
                   help="The top row's layer loop (scan: stacked block leaves, one body per "
                        "layer); the flagship and the sweep keep FLAGSHIP_LAYER_LOOP")
    p.add_argument("--tp-collective-matmul", action="store_true",
                   help="run the tensor-parallel projections as collective matmuls (needs a "
                        ">1 'model' axis to have any effect)")
    p.add_argument("--profile-dir", default=None,
                   help="trace the top row's timed window with torch.profiler into this "
                        "directory (the flagship row's into <dir>_flagship) and put each "
                        "row's step anatomy into the line")
    p.add_argument("--regress", default="auto", choices=["auto", "on", "off"],
                   help="record the rows in the port's registry with a verdict vs the last "
                        "known good on stderr (auto: only when the registry exists)")
    p.add_argument("--skip-preflight", action="store_true",
                   help="skip the graftcheck static preflight gate")
    p.add_argument("--registry", default=None,
                   help="registry root (default: $REGRESS_REGISTRY_TORCH or "
                        "results/registry_torch)")
    p.add_argument("--remat-sweep", action="store_true",
                   help="sweep the flagship arm across remat policies "
                        f"{REMAT_SWEEP_POLICIES} (the memory-vs-recompute frontier; "
                        "make_report renders the table)")
    return p


def registry_rows(args, payload, backend=None):
    """(source, contract_row, run_params) per registry record to ingest.

    Run parameters ride into each record, as in JAX: the registry's
    config_key includes them, so a --steps 12 smoke invocation forms its
    own lineage instead of polluting the default 100-step headline's noise
    floor. ``backend`` (the row's) rides beside the contract's
    ``device_kind``.
    """
    run_params = {
        "strategy": args.strategy, "tier": args.tier,
        "seq_len": args.seq_len, "steps": args.steps,
        "warmup_steps": args.warmup_steps,
        "sync_every": args.sync_every,
        "backend": backend,
    }
    rows = [("bench.py", {k: v for k, v in payload.items()
                          if k not in ("flagship", "remat_sweep")},
             dict(run_params, model_family=args.model_family,
                  per_device_batch=args.per_device_batch,
                  grad_accum=args.grad_accum,
                  layer_loop=args.layer_loop))]
    if "flagship" in payload:
        # The flagship sub-object already carries its geometry; only the
        # shared run length is added.
        rows.append(("bench.py:flagship", payload["flagship"], run_params))
    for pol, row in sorted(payload.get("remat_sweep", {}).items()):
        # One record per policy: the row's remat_policy keeps each its own
        # lineage; the flagship geometry is added as for the flagship.
        rows.append((f"bench.py:remat-sweep:{pol}", row,
                     dict(run_params, model_family=FLAGSHIP_FAMILY,
                          per_device_batch=FLAGSHIP_PER_DEVICE_BATCH,
                          grad_accum=FLAGSHIP_GRAD_ACCUM,
                          layer_loop=FLAGSHIP_LAYER_LOOP)))
    return rows


def record_in_registry(args, payload, backend=None) -> None:
    """Ingest this invocation's rows and report a verdict vs last-good.

    Best-effort, as in JAX: a broken registry must degrade the accounting,
    never fail the benchmark that just measured. Everything prints to
    stderr; exceptions are reported, not raised.
    """
    if args.regress == "off":
        return
    try:
        from .regress import compare as regress_compare
        from .regress import store as regress_store

        reg = regress_store.Registry(args.registry)
        if args.regress == "auto" and not reg.exists():
            print(f"regress: no registry at {reg.root} — skipping ingest (pass --regress on "
                  "to create it)", file=sys.stderr)
            return
        for source, row, extra in registry_rows(args, payload, backend):
            rec = regress_store.record_from_bench_row(row, source=source, extra_result=extra)
            rec, created = reg.ingest(rec)
            tag = "" if created else " (already ingested)"
            print(f"regress: recorded {rec['arm']} {rec['record_id']}{tag} -> {reg.root}",
                  file=sys.stderr)
            print(regress_compare.verdict_line_for_bench(reg, rec), file=sys.stderr)
    except Exception as e:  # never fail a measured run on bookkeeping
        print(f"WARNING: regress registry unavailable: {type(e).__name__}: {e}",
              file=sys.stderr)


def main(argv=None):
    """Run the rows and print the line (rank 0); returns the result rows
    the line was made from."""
    args = build_parser().parse_args(argv)
    if not args.skip_preflight:
        run_preflight()
    made_group = dist_rt.setup_distributed(device=args.device)
    try:
        top, payload = measure_row(args, model_family=args.model_family,
                                   per_device_batch=args.per_device_batch,
                                   grad_accum=args.grad_accum, attention_impl=args.attention,
                                   dropout=args.dropout, profile_dir=args.profile_dir,
                                   layer_loop=args.layer_loop)
        results = [top]
        if args.flagship == "on" or (args.flagship == "auto"
                                     and args.model_family != FLAGSHIP_FAMILY):
            flagship, row = measure_row(args, model_family=FLAGSHIP_FAMILY,
                                        per_device_batch=FLAGSHIP_PER_DEVICE_BATCH,
                                        grad_accum=FLAGSHIP_GRAD_ACCUM, attention_impl="flash",
                                        dropout=None,
                                        # Two arms' traces in one directory would
                                        # make the run selection ambiguous.
                                        profile_dir=(f"{args.profile_dir}_flagship"
                                                     if args.profile_dir else None))
            results.append(flagship)
            payload["flagship"] = {
                **row,
                "model_family": FLAGSHIP_FAMILY,
                "strategy": args.strategy,
                "tier": args.tier,
                "seq_len": args.seq_len,
                "per_device_batch": FLAGSHIP_PER_DEVICE_BATCH,
                "grad_accum": FLAGSHIP_GRAD_ACCUM,
                "layer_loop": FLAGSHIP_LAYER_LOOP,
            }
        if args.remat_sweep:
            sweep = {}
            for pol in REMAT_SWEEP_POLICIES:
                result, sweep[pol] = measure_row(
                    args, model_family=FLAGSHIP_FAMILY,
                    per_device_batch=FLAGSHIP_PER_DEVICE_BATCH,
                    grad_accum=FLAGSHIP_GRAD_ACCUM, attention_impl="flash", dropout=None,
                    remat=pol)
                results.append(result)
            payload["remat_sweep"] = sweep
        if dist_rt.is_main_process():
            print(json.dumps(payload), flush=True)
            record_in_registry(args, payload, backend=top.backend)
        return results
    finally:
        if made_group:
            dist_rt.cleanup_distributed()


if __name__ == "__main__":
    main()
