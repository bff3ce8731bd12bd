"""One rank of the checkpoint checks over gloo on the CPU: the helper of
``tests/test_torch_checkpoint.py``, which holds no test itself and imports
torch and the port only.

    python tests/torch_ckpt_worker.py RANK WORLD PORT DIR

Every run is ``run_benchmark`` at tier S, S 64, fp32 compute, dropout 0.1,
per-device batch 1 x accum 2, warmup 1, over (data WORLD). For each arm of
``ARMS``: 4 steps straight; 4 steps into ``DIR/<label>`` with a SIGTERM at
step 0's boundary, where the ranks agree to stop at step 1 and save it (the
emergency checkpoint); then a resume to 4 steps from there (steps 2 and
3): every step's loss, and the resumed row; the same for zero2 under each
layout of ``GROUP_ARMS`` (``model`` shards, a ``pipe`` stage each, the
``expert`` shards of a MoE model). Then the geometry change: a resume
to 4 steps of ``DIR/w1`` (zero2 saved by one process at per-device batch
2, the same global batch), and zero2 2 steps saved into ``DIR/w2`` (which
one process then resumes). Writes ``DIR/out.rank<RANK>.json``.

    python tests/torch_ckpt_worker.py async RANK WORLD PORT DIR

The async save under load (world 1 runs without a group): zero2, 8 steps
straight; then the same 8 steps with an async save every 2 steps and a
SIGTERM that stops the run at step 5's boundary, the last rank's writes
slowed by ``ASYNC_WRITE_DELAY_S`` so that steps run, and the next save
starts, while a write is in flight (one rank's write waits in DCP's
closing collective while another's still writes); the emergency flush
there commits step 4's save, written while step 5 ran; then a resume from
that step. Writes ``DIR/async.rank<RANK>.json``: the losses of the three
runs, the committed step, the telemetry events of the preempted run, and
for each slowed write the steps the loop had finished when it began and
ended.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch
from torch.distributed.checkpoint.filesystem import FileSystemWriter

from distributed_llm_training_benchmark_framework_tpu_torch.parallel.strategies import (
    get_strategy,
)
from distributed_llm_training_benchmark_framework_tpu_torch.faults import Preempted
from distributed_llm_training_benchmark_framework_tpu_torch.runtime import distributed as rt
from distributed_llm_training_benchmark_framework_tpu_torch.telemetry.recorder import (
    read_events,
    telemetry_filename,
)
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark

REPO = Path(__file__).resolve().parents[1]
RUN = dict(tier="S", seq_len=64, warmup_steps=1, device="cpu", sync_every=1, dropout=0.1,
           grad_accum=2)


def strategy(label):
    """The arm of a label (fp32 compute)."""
    arm = {"offload_serial": "zero2", "offload_delayed": "zero2", "bf16": "zero2"}.get(label,
                                                                                      label)
    change = {"offload_serial": dict(offload_opt_state=True),
              "offload_delayed": dict(offload_opt_state=True, offload_delayed_update=True),
              "bf16": dict(param_dtype="bf16")}.get(label, {})
    return dataclasses.replace(get_strategy(arm), precision="f32", **change)


ARMS = ("ddp", "fsdp", "zero2", "zero3", "offload_serial", "offload_delayed", "bf16")
# Layouts that need the group: the run_benchmark options of each (zero2).
GROUP_ARMS = {"tp2": dict(tensor_parallel=2), "pp2": dict(pipeline_parallel=2),
              "ep2": dict(n_experts=4, expert_parallel=2)}


ASYNC_STEPS, ASYNC_EVERY = 8, 2
# The fault's step by world size: over a group the ranks agree to stop at
# the boundary after the one where the signal landed; both stop at step 5.
ASYNC_SIGTERM = {1: 5, 2: 4}
ASYNC_WRITE_DELAY_S = 1.5  # a tier-S step on one CPU thread takes well under it


def spawn_ranks(world, out, mode=()):
    """Start this script on ``world`` gloo ranks on localhost (``mode``:
    ``("async",)`` for the async scenario)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "INJECT_FAULT"):
        env.pop(var, None)
    return [subprocess.Popen([sys.executable, __file__, *mode, str(r), str(world), str(port),
                              str(out)], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def wait_ranks(procs, timeout=300):
    """Wait for every rank; kill them all on the way out (a hang fails here)."""
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def async_main(rank, world, out):
    """The async scenario of the module docstring on this rank."""
    kw = dict(RUN, strategy=strategy("zero2"), per_device_batch=1, steps=ASYNC_STEPS)
    straight, first, second, writes = [], [], [], []
    run_benchmark(loss_log=straight, telemetry=False, **kw)
    write_data = FileSystemWriter.write_data

    def slow_write_data(self, *args, **kwargs):
        began = len(first)
        assert threading.current_thread() is not threading.main_thread()
        time.sleep(ASYNC_WRITE_DELAY_S)
        try:
            return write_data(self, *args, **kwargs)
        finally:
            writes.append([began, len(first)])

    ck = dict(checkpoint_dir=os.path.join(out, "async"), checkpoint_every=ASYNC_EVERY)
    if rank == world - 1:
        FileSystemWriter.write_data = slow_write_data
    try:
        run_benchmark(loss_log=first, checkpoint_async=True,
                      inject_fault=f"sigterm@{ASYNC_SIGTERM[world]}",
                      results_dir=os.path.join(out, f"async_r{world}"), **ck, **kw)
        raise AssertionError("the SIGTERM did not stop the run")
    except Preempted as e:
        saved = e.saved_step
    finally:
        FileSystemWriter.write_data = write_data
    row = run_benchmark(loss_log=second, resume=True, telemetry=False, **ck, **kw)
    name = telemetry_filename(f"zero2_ws{world}_seq64_tierS", rank)
    events = read_events(os.path.join(out, f"async_r{world}", name))
    return {"straight": straight, "first": first, "second": second, "saved": saved,
            "writes": writes, "events": events, "row": row.to_dict()}


def main():
    mode = sys.argv[1] if sys.argv[1] == "async" else None
    rank, world, port, out = sys.argv[1 + bool(mode):5 + bool(mode)]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    if mode and world == 1:
        with open(os.path.join(out, "async.rank0.json"), "w") as f:
            json.dump(async_main(0, 1, out), f)
        return
    assert rt.setup_distributed(num_processes=world, process_id=rank, master_port=int(port),
                                device="cpu")
    if mode:
        try:
            res = async_main(rank, world, out)
        finally:
            rt.barrier()
            rt.cleanup_distributed()
        with open(os.path.join(out, f"async.rank{rank}.json"), "w") as f:
            json.dump(res, f)
        return
    res = {}
    try:
        for label in ARMS + tuple(GROUP_ARMS):
            kw = dict(RUN, strategy=strategy(label if label in ARMS else "zero2"),
                      per_device_batch=1, telemetry=False, **GROUP_ARMS.get(label, {}))
            straight, resumed = [], []
            run_benchmark(steps=4, loss_log=straight, **kw)
            ck = os.path.join(out, label)
            try:
                run_benchmark(steps=4, loss_log=resumed, checkpoint_dir=ck,
                              inject_fault="sigterm@0", **kw)
                raise AssertionError(f"{label}: the SIGTERM did not stop the run")
            except Preempted as e:
                assert (e.step, e.saved_step) == (1, 1), (label, e.step, e.saved_step)
            row = run_benchmark(steps=4, loss_log=resumed, checkpoint_dir=ck, resume=True,
                                results_dir=os.path.join(out, f"res_{label}"), **kw)
            res[label] = {"straight": straight, "resumed": resumed, "row": row.to_dict()}
        kw = dict(RUN, strategy=strategy("zero2"), per_device_batch=1, telemetry=False)
        from_w1 = []
        row = run_benchmark(steps=4, loss_log=from_w1, checkpoint_dir=os.path.join(out, "w1"),
                            resume=True, **kw)
        res["from_w1"] = {"losses": from_w1, "row": row.to_dict()}
        run_benchmark(steps=2, checkpoint_dir=os.path.join(out, "w2"), **kw)
    finally:
        rt.barrier()
        rt.cleanup_distributed()
    with open(os.path.join(out, f"out.rank{rank}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
