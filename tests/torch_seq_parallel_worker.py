"""One rank of the sequence-parallel checks over gloo on the CPU: the helper
of ``tests/test_torch_ulysses.py``, ``tests/test_torch_seq_parallel.py`` and
``tests/test_torch_ring_attention.py``, which holds no test itself and
imports torch and the port only.

    python tests/torch_seq_parallel_worker.py RANK WORLD PORT INPUTS OUT MODE

``MODE``:

- ``attention``: ``INPUTS`` holds (B, S, H, Dh) ``q``, ``k``, ``v``, ``do``.
  Every rank of the world is one ``seq`` shard and runs
  ``ulysses_attention_sharded`` on its columns at rate 0 and 0.1, causal
  and not; at world 4 the ranks are also laid out (data 2, seq 2) by
  ``make_mesh`` and run ``ulysses_attention_sharded`` (the data shard
  folded into the seed) and ``ring_attention_sharded`` (keyed by its batch
  offset) on their row and columns at rate 0.1. Records each output and
  the gradients of ``sum(out * do)``.
- ``train``: ``INPUTS`` holds each family's JAX params (``tinygpt.wte``,
  ``llama.blocks.wq``, ...) and the batch table. The ranks are laid out
  (data world/2, seq 2); for each family, attention (ring, Ulysses) and arm
  of ``ARMS[world]``, tier S at S 128, fp32 compute, dropout 0, per-device
  batch 1 x accum 2, loaded from the JAX params, laid out by
  ``apply_strategy`` and trained 3 steps by ``TrainStep``: every step's
  loss, the final params (rank 0), the sizes of this rank's params and
  AdamW moments, and the bytes it holds beside ``estimate_hbm``'s. Then
  ``run_benchmark`` (zero2 in fp32) at dropout 0.1 for ring and Ulysses
  (seeded weights):
  every step's loss and the result row; and the refusal of a ``seq`` width
  of 3, which the world does not divide.

Writes ``OUT.rank<RANK>.npz`` and ``OUT.rank<RANK>.json``. The tests start
the ranks with ``spawn_ranks`` and wait with ``wait_ranks``.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT, get_config
from distributed_llm_training_benchmark_framework_tpu_torch.ops import ring_attention as tra
from distributed_llm_training_benchmark_framework_tpu_torch.ops import ulysses_attention as tua
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import make_mesh
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.runtime import distributed as rt
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark
from distributed_llm_training_benchmark_framework_tpu_torch.train.step import TrainStep
from distributed_llm_training_benchmark_framework_tpu_torch.utils import memory

from test_torch_arms_worker import _local, held_bytes

S, MICRO, ACCUM, STEPS, SP = 128, 1, 2, 3, 2
SEED = 555
FAMILIES = ("tinygpt", "llama")
IMPLS = ("ring", "ulysses")
# The arms each world trains: every arm over (data 2, seq 2), and the bench's
# default arm over (data 1, seq 2).
ARMS = {4: ("ddp", "fsdp", "zero2", "zero3"), 2: ("zero2",)}
CPU = torch.device("cpu")
# The bench's default arm, computing in fp32.
F32_ZERO2 = dataclasses.replace(tstrat.get_strategy("zero2"), precision="f32")
REPO = Path(__file__).resolve().parents[1]


def spawn_ranks(world, inputs, out, mode):
    """Start this script on ``world`` gloo ranks on localhost; returns the
    processes (``wait_ranks`` waits for them)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    return [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(port), str(inputs), str(out), mode],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def wait_ranks(procs):
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]


def _out_and_grads(fn, q, k, v, do):
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v)
    grads = torch.autograd.grad((out * do).sum(), (q, k, v))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


def attention(rank, world, data, out):
    q, k, v, do = (torch.from_numpy(data[x]) for x in ("q", "k", "v", "do"))
    arrays = {}
    Sl = q.shape[1] // world
    cols = slice(rank * Sl, (rank + 1) * Sl)
    for causal in (False, True):
        for rate in (0.0, 0.1):
            got = _out_and_grads(
                lambda a, b, c: tua.ulysses_attention_sharded(
                    a, b, c, causal=causal, dropout_rate=rate, dropout_seed=SEED),
                *(t[:, cols] for t in (q, k, v, do)))
            for name, x in zip(("out", "dq", "dk", "dv"), got):
                arrays[f"ulysses.{causal}.{rate}.{name}"] = x
    if world == 4:
        mesh = make_mesh((SP,), ("seq",))
        d, s = mesh.data_rank, mesh.seq_rank
        assert (mesh.size("data"), d, s) == (2, rank // SP, rank % SP)
        Sl = q.shape[1] // SP
        rows, cols = slice(d, d + 1), slice(s * Sl, (s + 1) * Sl)
        part = [t[rows, cols] for t in (q, k, v, do)]
        forms = {
            "ulysses": lambda a, b, c: tua.ulysses_attention_sharded(
                a, b, c, group=mesh.seq_group, dropout_rate=0.1, dropout_seed=SEED,
                batch_shard=(d, 2)),
            "ring": lambda a, b, c: tra.ring_attention_sharded(
                a, b, c, group=mesh.seq_group, dropout_rate=0.1, dropout_seed=SEED,
                batch_offset=d),
        }
        for form, fn in forms.items():
            for name, x in zip(("out", "dq", "dk", "dv"), _out_and_grads(fn, *part)):
                arrays[f"dseq.{form}.{name}"] = x
    np.savez(f"{out}.rank{rank}.npz", **arrays)
    return {}


def _tree(data, family):
    params = {"blocks": {}}
    for key in data.files:
        if not key.startswith(family + "."):
            continue
        leaf = key.split(".", 1)[1]
        if leaf.startswith("blocks."):
            params["blocks"][leaf.split(".", 1)[1]] = data[key]
        else:
            params[leaf] = data[key]
    return params


def train(rank, world, data, out):
    table = torch.from_numpy(data["table"].astype(np.int64))
    mesh = make_mesh((SP,), ("seq",))
    res = {"mesh": [mesh.size("data"), mesh.data_rank, mesh.seq_rank, mesh.world],
           "losses": {}, "sizes": {}, "bytes": {}, "rows": {}, "dropout_losses": {}}
    arrays = {}
    for family in FAMILIES:
        params = _tree(data, family)
        for impl in IMPLS:
            for arm in ARMS[world]:
                label = f"{family}.{impl}.{arm}"
                strat = dataclasses.replace(tstrat.get_strategy(arm), precision="f32",
                                            remat="none")
                cfg = get_config(family, "S", S, dropout=0.0, compute_dtype=torch.float32,
                                 attention_impl=impl)
                model = TinyGPT(cfg, mesh=mesh)
                bridge.load_jax_params(model, params)
                est = memory.estimate_hbm(cfg, strat, mesh, MICRO, S)
                model, opt = tstrat.apply_strategy(model, strat, mesh)
                step_fn = TrainStep(model, opt, grad_accum=ACCUM, micro_batch=MICRO, seed=0,
                                    device=CPU, mesh=mesh)
                res["losses"][label] = [step_fn(table, step).item() for step in range(STEPS)]
                got = bridge.export_params(model)
                if rank == 0:
                    arrays[f"{label}.wte"] = got["wte"]
                    for leaf in got["blocks"]:
                        arrays[f"{label}.blocks.{leaf}"] = got["blocks"][leaf]
                    for leaf in (k for k in got if k not in ("wte", "blocks")):
                        arrays[f"{label}.{leaf}"] = got[leaf]
                res["sizes"][label] = {
                    "param_local": sum(_local(p).numel() for p in model.parameters()),
                    "param_global": sum(p.numel() for p in model.parameters()),
                    "moments": sum(_local(st["exp_avg"]).numel()
                                   for st in opt.adamw.state.values()),
                    "leaf_shapes": [list(p.shape) for p in model.parameters()],
                    "leaf_names": [name for name, _ in model.named_parameters()],
                }
                res["bytes"][label] = {"held": list(held_bytes(model, opt)),
                                       "estimate": [est.params, est.grads, est.opt_state]}
    try:
        make_mesh((3,), ("seq",))
    except ValueError as e:
        res["refusal"] = str(e)
    for impl in IMPLS:
        losses = []
        row = run_benchmark(strategy=F32_ZERO2, tier="S", seq_len=S, steps=STEPS, warmup_steps=1,
                            per_device_batch=MICRO, grad_accum=ACCUM, attention_impl=impl,
                            sequence_parallel=SP, dropout=0.1, device="cpu", world_size=world,
                            loss_log=losses)
        res["rows"][impl] = row.to_dict()
        res["dropout_losses"][impl] = losses
    np.savez(f"{out}.rank{rank}.npz", **arrays)
    return res


def main():
    rank, world, port, inputs, out, mode = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    assert rt.setup_distributed(num_processes=world, process_id=rank, master_port=int(port),
                                device="cpu")
    try:
        res = {"attention": attention, "train": train}[mode](rank, world, np.load(inputs), out)
    finally:
        rt.cleanup_distributed()
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
