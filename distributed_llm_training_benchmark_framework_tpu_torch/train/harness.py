"""CLI harness: the JAX package's flags, run by the port on the card.

    python -m distributed_llm_training_benchmark_framework_tpu_torch.train.harness \\
        --strategy zero2 --world-size 1 --tier A --seq-len 2048 --steps 12 \\
        --per-device-batch 1 --grad-accum 4 --results-dir R [--device cpu]

Port of ``distributed_llm_training_benchmark_framework_tpu/train/harness.py``
(its parser, ``resolve_strategy`` and ``main``'s exit codes). Every flag the
JAX harness accepts is here with its default, and is either live or refused
with the reason (``REFUSED``); none is accepted and ignored. The one flag
added is ``--device`` (``cuda`` by default; ``cpu`` on request, for gloo
runs on the host).

- ``--world-size`` is the process group's size, one card per process.
  Under torchrun, or with ``--num-processes`` / ``--rank`` (and
  ``--master-addr`` / ``--master-port``), the harness joins the group
  through ``runtime.setup_distributed``; another world size than the
  group's is refused.
- ``--strategy-config``, ``--deepspeed-config`` and ``--fsdp-config`` are
  aliases; a DeepSpeed-format JSON is translated into the arm
  (``parallel.strategies.from_deepspeed_config``), and the ZeRO arms read
  ``configs/strategies/<arm>.json`` when none is given, as the reference
  demands a config for them.
- ``--sentinel on`` arms the numerics sentinel (``--sentinel-checksum-every``
  N adds its parameter checksum every N steps), which heals a trip by an
  in-process rollback; a trip it cannot heal (no checkpoint and no
  snapshot, or its rollbacks spent) fails the run plainly
  (``SentinelTripped``, exit 1). ``--data-path DIR`` trains on the shard
  stream under DIR (make shards with ``python -m
  distributed_llm_training_benchmark_framework_tpu_torch.data.make_shards``),
  and ``--data-stall-timeout-sec`` bounds the wait for a batch.
- ``--profile-dir DIR`` traces the timed window with ``torch.profiler``
  (rank 0) into DIR, with ``cost_analysis.json`` beside it, and puts the
  step anatomy into the row (``analysis/step_anatomy.py``; read the trace
  again with ``analysis.profile_summary`` / ``analysis.step_anatomy`` /
  ``analysis.telemetry_report --profile-dir``).
- Exit codes (``faults``): 0 done; 75 preempted after an emergency
  checkpoint, 76 hung (a watchdog abort) and 78 the input stream stalled
  (an emergency checkpoint with the stream's cursor), all retryable with
  ``--resume``; 77 a ``--resume`` with no steps left, terminal.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from ..parallel.strategies import (
    STRATEGIES,
    from_deepspeed_config,
    get_strategy,
    is_deepspeed_config,
    load_strategy_config,
)
from ..data import DataStalled
from ..faults import (
    EXIT_DATA_STALL,
    EXIT_HUNG,
    EXIT_NOTHING_TO_RESUME,
    EXIT_PREEMPTED,
    Hung,
    NothingToResume,
    Preempted,
)
from ..runtime import distributed as dist_rt
from .loop import run_benchmark

_XLA = ("an XLA or Pallas knob with no counterpart in the port: the Hopper kernels' tiles "
        "and backward are fixed (ROADMAP Queue 3, decided differences)")

#: dest -> (the port's default, the reason any other value is refused).
REFUSED = {
    "layer_loop": ("unrolled", "eager PyTorch runs the layers as a Python loop; a 'scan' form "
                               "has no meaning here yet (ROADMAP Queue 1 item 0)"),
    "xla_latency_hiding": (False, _XLA),
    "prng_impl": ("rbg", "the port's dropout draws from torch generators and its kernels' "
                         "coordinate hash; JAX's threefry has no counterpart (ROADMAP Queue 3)"),
    "flash_block_q": (None, _XLA),
    "flash_block_k": (None, _XLA),
    "flash_block_k_bwd": (None, _XLA),
    "flash_pallas_backward": (False, _XLA),
    "flash_blockwise_backward": (False, _XLA),
    "debug": (False, "JAX's fail-fast NaN and tracer-leak checks; not ported"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distributed_llm_training_benchmark_framework_tpu_torch.train.harness",
        description="Distributed training benchmark (PyTorch port)")
    p.add_argument("--strategy", type=str, required=True, choices=sorted(STRATEGIES),
                   help="Distributed strategy arm")
    p.add_argument("--device", default=None,
                   help="cuda (default: one card per process) or cpu (gloo on the host)")
    # Distributed
    p.add_argument("--world-size", type=int, required=True,
                   help="Processes (cards) of the group; must equal the group's size")
    p.add_argument("--rank", type=int, default=0, help="Global process rank")
    p.add_argument("--local-rank", type=int, default=0,
                   help="This process's card on its host, when LOCAL_RANK is not set")
    p.add_argument("--master-addr", type=str, default="localhost",
                   help="Rendezvous address (with --num-processes)")
    p.add_argument("--master-port", type=int, default=29500)
    p.add_argument("--num-processes", type=int, default=None,
                   help="Processes of the group (default: the launcher's WORLD_SIZE / "
                        "NUM_PROCESSES, or no group)")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="Tensor-parallel ('model' axis) width")
    p.add_argument("--sequence-parallel", type=int, default=1,
                   help="Sequence-parallel ('seq' axis) width; needs --attention ring or "
                        "ulysses")
    p.add_argument("--pipeline-parallel", type=int, default=1,
                   help="Pipeline ('pipe' axis) width; the grad-accum micro-batches feed the "
                        "schedule")
    p.add_argument("--skip-memory-check", action="store_true",
                   help="Attempt the run even when the memory model says it will not fit")
    p.add_argument("--pipeline-schedule", choices=["gpipe", "1f1b", "interleaved"],
                   default="gpipe", help="Pipeline schedule")
    p.add_argument("--virtual-stages", type=int, default=2,
                   help="Layer chunks per stage under --pipeline-schedule interleaved")
    p.add_argument("--expert-parallel", type=int, default=1,
                   help="Expert-parallel ('expert' axis) width")
    p.add_argument("--num-experts", type=int, default=0,
                   help="Mixture-of-Experts MLP with this many experts (0: dense)")
    # Model and data
    p.add_argument("--tier", type=str, required=True, choices=["A", "B", "S"],
                   help="Model tier (S: the small test tier)")
    p.add_argument("--model-family", choices=["tinygpt", "llama"], default="tinygpt",
                   help="Model family")
    p.add_argument("--seq-len", type=int, required=True)
    p.add_argument("--synthetic", action="store_true", default=True,
                   help="Synthetic data (the device-resident table; --data-path overrides it "
                        "with the streaming path)")
    p.add_argument("--data-path", type=str, default=None,
                   help="Directory of tokenized record shards (data/make_shards.py format): the "
                        "streaming input path, with checksummed records, skip-and-quarantine, "
                        "bounded read retries, exact-resume cursor sidecars and a published "
                        "data_stall_frac")
    p.add_argument("--data-stall-timeout-sec", type=float, default=60.0,
                   help="With --data-path: stop as reason=data_stall (exit 78, retryable with "
                        "--resume) when the loop waits this long for a batch; keep it below "
                        "--hang-timeout-sec")
    p.add_argument("--dataset-size", type=int, default=1000,
                   help="Rows of the synthetic table")
    p.add_argument("--attention", type=str, default="reference",
                   choices=["reference", "flash", "ring", "ulysses"],
                   help="Attention implementation (flash: the hand-written kernels)")
    p.add_argument("--dropout", type=float, default=None,
                   help="Override the model's dropout rate")
    p.add_argument("--ring-zigzag", choices=["auto", "on", "off"], default="auto",
                   help="Zigzag causal load balancing on ring attention")
    p.add_argument("--causal", action="store_true", help="Causal attention masking")
    p.add_argument("--flash-block-q", type=int, default=None, help="Refused: " + _XLA)
    p.add_argument("--flash-block-k", type=int, default=None, help="Refused: " + _XLA)
    p.add_argument("--prng-impl", choices=["rbg", "threefry"], default="rbg",
                   help="rbg: the port's own generators (threefry is refused)")
    p.add_argument("--tp-collective-matmul", action="store_true",
                   help="Run the tensor-parallel projections as collective matmuls")
    p.add_argument("--layer-loop", choices=["scan", "unrolled"], default="unrolled",
                   help="unrolled (scan is refused: eager PyTorch loops over the layers)")
    p.add_argument("--flash-pallas-backward", action="store_true", help="Refused: " + _XLA)
    p.add_argument("--flash-blockwise-backward", action="store_true", help="Refused: " + _XLA)
    p.add_argument("--flash-block-k-bwd", type=int, default=None, help="Refused: " + _XLA)
    # Training
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--warmup-steps", type=int, default=5)
    p.add_argument("--per-device-batch", type=int, required=True)
    p.add_argument("--grad-accum", type=int, required=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--sync-every", type=int, default=1,
                   help="Fence the device every N steps (1: the reference's per-step sync)")
    # Configs
    p.add_argument("--offload-opt-state", action="store_true",
                   help="ZeRO-Offload: fp32 masters and AdamW in pinned host memory")
    p.add_argument("--offload-delayed-update", action="store_true",
                   help="With --offload-opt-state: overlap the host update with the next "
                        "step (parameters lag one step)")
    p.add_argument("--offload-dpu-start-step", type=int, default=0,
                   help="With --offload-delayed-update: serial host updates until this step. "
                        "Incompatible with --resume")
    p.add_argument("--param-dtype", choices=["f32", "bf16"], default=None,
                   help="Parameter / AdamW-state storage dtype (default: the arm's)")
    p.add_argument("--strategy-config", type=str, default=None,
                   help="Path to a configs/strategies/*.json file")
    p.add_argument("--deepspeed-config", type=str, default=None,
                   help="Alias for --strategy-config (reference CLI parity)")
    p.add_argument("--fsdp-config", type=str, default=None,
                   help="Alias for --strategy-config (reference CLI parity)")
    # Output
    p.add_argument("--results-dir", type=str, required=True)
    p.add_argument("--profile-dir", type=str, default=None,
                   help="Trace the timed window with torch.profiler into this directory (rank "
                        "0) and put its step anatomy into the result")
    p.add_argument("--telemetry", choices=["on", "off"], default="on",
                   help="Flight-recorder telemetry: telemetry_<arm>.jsonl beside the result "
                        "and BENCHMARK_HEARTBEAT stdout markers")
    p.add_argument("--heartbeat-sec", type=float, default=30.0,
                   help="Minimum seconds between heartbeats (0: every window)")
    # Checkpoint / resume
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="Save every N steps (0: only the final step)")
    p.add_argument("--checkpoint-async", action="store_true",
                   help="Periodic saves stage the state in host memory and write it on a "
                        "thread; the commit is fenced at a later boundary")
    p.add_argument("--resume", action="store_true",
                   help="Resume from the newest valid checkpoint in --checkpoint-dir (one "
                        "saved under another mesh is resharded)")
    p.add_argument("--debug", action="store_true", help="Refused: not ported")
    # Chaos harness
    p.add_argument("--inject-fault", type=str, default=None,
                   help="Arm one deterministic fault: sigkill@N, sigterm@N, "
                        "sigterm-rank@N:R, nan-loss@N, hang@N[:SECS], stall-rank@N:R[:SECS], "
                        "bitflip@N, grad-explode@N, opt-moments@N, torn-checkpoint, "
                        "enospc-on-save, data-stall@N[:SECS], data-corrupt-record@N, "
                        "data-slow-reader@N:MS, data-missing-shard@K (INJECT_FAULT when not "
                        "given)")
    p.add_argument("--hang-timeout-sec", type=float, default=0.0,
                   help="Arm the hang watchdog: no sync-window boundary for this long dumps "
                        "every thread's stack into a hang_dump event and exits 76 (0: off)")
    p.add_argument("--sentinel", choices=["on", "off"], default="off",
                   help="Numerics sentinel: judge each synced step's loss and global grad norm; "
                        "on a trip roll back in process to the last validated checkpoint (or, "
                        "with no checkpoint cadence on one process, a host snapshot) and replay")
    p.add_argument("--sentinel-checksum-every", type=int, default=0,
                   help="With --sentinel on: every N steps, checksum the parameters (global L2 "
                        "norm) at a fenced boundary to catch silent corruption (0: off)")
    p.add_argument("--xla-latency-hiding", action="store_true", help="Refused: " + _XLA)
    return p


def refuse_unported(args: argparse.Namespace) -> None:
    """SystemExit naming the first flag set away from its default that the
    port does not run, and what it waits for."""
    for dest, (default, reason) in REFUSED.items():
        value = getattr(args, dest)
        if value != default:
            flag = "--" + dest.replace("_", "-")
            raise SystemExit(f"{flag} {value!r} is not supported by the port: {reason}")


def resolve_strategy(args: argparse.Namespace):
    """The arm: the named one, or read from the config path (the port's JSON
    format, or a DeepSpeed config translated into the arm)."""
    path = args.strategy_config or args.deepspeed_config or args.fsdp_config
    if path and not os.path.exists(path):
        raise FileNotFoundError(f"strategy config not found: {path}")
    if path:
        with open(path) as f:
            try:
                raw = json.load(f)
            except json.JSONDecodeError as e:
                raise ValueError(f"strategy config {path} is not valid JSON: {e}")
        if isinstance(raw, dict) and "strategy" in raw:
            sc = load_strategy_config(path)
            if sc.name != args.strategy:
                raise ValueError(f"--strategy {args.strategy} but config file is for {sc.name}")
            return sc
        if is_deepspeed_config(raw):
            print(f"Note: translating DeepSpeed-format config {path} into the "
                  f"{args.strategy!r} arm")
            return from_deepspeed_config(raw, args.strategy)
        print(f"Note: {path} is not a recognized strategy config format; using built-in "
              f"{args.strategy!r} defaults")
    return get_strategy(args.strategy)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    if args.strategy in ("zero2", "zero3") and not (
            args.strategy_config or args.deepspeed_config or args.fsdp_config):
        # The reference demands a config for the ZeRO arms.
        default = os.path.join(os.path.dirname(__file__), "..", "..", "configs", "strategies",
                               f"{args.strategy}.json")
        if not os.path.exists(default):
            raise ValueError("ZeRO strategy requires --strategy-config")
        args.strategy_config = default
    strategy = resolve_strategy(args)
    if args.param_dtype is not None:
        strategy = dataclasses.replace(strategy, param_dtype=args.param_dtype)
    if args.offload_opt_state:
        strategy = dataclasses.replace(strategy, offload_opt_state=True)
    if args.offload_delayed_update:
        if not strategy.offload_opt_state:
            raise SystemExit("--offload-delayed-update requires --offload-opt-state (it "
                             "schedules the host optimizer update; there is nothing to delay "
                             "on a device-resident optimizer)")
        strategy = dataclasses.replace(strategy, offload_delayed_update=True)
    if args.local_rank != 0 and "LOCAL_RANK" not in os.environ:
        os.environ["LOCAL_RANK"] = str(args.local_rank)
    explicit = args.num_processes is not None
    dist_rt.setup_distributed(
        master_addr=args.master_addr if explicit else None,
        master_port=args.master_port if explicit else None,
        num_processes=args.num_processes, process_id=args.rank if explicit else None,
        device=args.device)
    try:
        run_benchmark(
            strategy=strategy, tier=args.tier, model_family=args.model_family,
            seq_len=args.seq_len, steps=args.steps, warmup_steps=args.warmup_steps,
            per_device_batch=args.per_device_batch, grad_accum=args.grad_accum,
            world_size=args.world_size, device=args.device,
            tensor_parallel=args.tensor_parallel, sequence_parallel=args.sequence_parallel,
            pipeline_parallel=args.pipeline_parallel,
            pipeline_schedule=args.pipeline_schedule, virtual_stages=args.virtual_stages,
            skip_memory_check=args.skip_memory_check, expert_parallel=args.expert_parallel,
            n_experts=args.num_experts, results_dir=args.results_dir, seed=args.seed,
            attention_impl=args.attention, dropout=args.dropout, causal=args.causal,
            ring_zigzag={"auto": None, "on": True, "off": False}[args.ring_zigzag],
            tp_collective_matmul=args.tp_collective_matmul,
            offload_dpu_start_step=args.offload_dpu_start_step,
            dataset_size=args.dataset_size, sync_every=args.sync_every,
            checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
            checkpoint_async=args.checkpoint_async, resume=args.resume,
            telemetry=args.telemetry == "on", heartbeat_sec=args.heartbeat_sec,
            inject_fault=args.inject_fault, hang_timeout_sec=args.hang_timeout_sec,
            sentinel=args.sentinel == "on", sentinel_checksum_every=args.sentinel_checksum_every,
            data_path=args.data_path, data_stall_timeout_sec=args.data_stall_timeout_sec,
            profile_dir=args.profile_dir,
        )
    except Preempted as e:
        print(f"PREEMPTED: {e} — exiting {EXIT_PREEMPTED} (resume with --resume)", flush=True)
        return EXIT_PREEMPTED
    except NothingToResume as e:
        print(f"NOTHING TO RESUME: {e} — exiting {EXIT_NOTHING_TO_RESUME}", flush=True)
        return EXIT_NOTHING_TO_RESUME
    except DataStalled as e:
        print(f"DATA STALL: {e} — exiting {EXIT_DATA_STALL} (resume with --resume)", flush=True)
        return EXIT_DATA_STALL
    except Hung as e:
        print(f"HUNG: {e} — exiting {EXIT_HUNG} (retryable with --resume)", flush=True)
        return EXIT_HUNG
    finally:
        dist_rt.cleanup_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
