"""One rank of the strategy arms over gloo on the CPU: the helper of
``tests/test_torch_arms.py`` and ``tests/test_torch_memory.py``, which
holds no test itself and imports torch and the port only.

    python tests/test_torch_arms_worker.py RANK WORLD PORT INPUTS OUT MODE

``INPUTS`` is an .npz of the JAX params (``wte``, ``blocks.wqkv``, ...) and
the batch table (``table``). ``MODE``:

- ``parity``: for each arm of ``ARMS``, tier S TinyGPT at S 64, fp32
  compute, flash, dropout 0, loaded from the JAX params, laid out by
  ``apply_strategy`` and trained 3 steps by ``TrainStep`` (per-device
  batch 1 x accum 2); records every step's loss, the gathered params after
  every step (rank 0), the sizes of this rank's params and AdamW moments,
  and the world-``WORLD`` result row of ``run_benchmark`` for the arm;
- ``bytes``: for each arm and family, the arm at tier S (seed weights),
  one step, then the bytes this rank holds in params, grads and AdamW
  moments (unique storages), beside ``utils.memory.estimate_hbm``'s.

Writes ``OUT.rank<RANK>.npz`` and ``OUT.rank<RANK>.json``. The tests start
the ranks with ``spawn_ranks`` and ``wait_ranks``.
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
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import make_mesh
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.runtime import distributed as rt
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark
from distributed_llm_training_benchmark_framework_tpu_torch.train.step import TrainStep
from distributed_llm_training_benchmark_framework_tpu_torch.utils import memory

S, MICRO, ACCUM, STEPS = 64, 1, 2, 3
# (label, arm, remat): zero3 also with remat "dots" and "full" (FSDP2's
# hooks inside the checkpointed blocks), which must not change the result.
ARMS = (("ddp", "ddp", None), ("fsdp", "fsdp", None), ("zero2", "zero2", None),
        ("zero3", "zero3", "none"), ("zero3_dots", "zero3", "dots"),
        ("zero3_full", "zero3", "full"))
CPU = torch.device("cpu")
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


def _strategy(arm, remat=None):
    s = dataclasses.replace(tstrat.get_strategy(arm), precision="f32")
    return s if remat is None else dataclasses.replace(s, remat=remat)


def _tree(data):
    params = {"blocks": {}}
    for key in data.files:
        if key.startswith("blocks."):
            params["blocks"][key.split(".", 1)[1]] = data[key]
        elif key != "table":
            params[key] = data[key]
    return params


def _local(t):
    return t.to_local() if isinstance(t, torch.distributed.tensor.DTensor) else t


def _unique_bytes(tensors):
    seen = {}
    for t in tensors:
        st = _local(t).untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def held_bytes(model, opt):
    """Bytes of params, grads and AdamW moments this rank holds."""
    params = list(model.parameters()) + opt.params
    grads = [p.grad for p in params if p.grad is not None]
    moments = [st[k] for st in opt.adamw.state.values() for k in ("exp_avg", "exp_avg_sq")]
    return _unique_bytes(params), _unique_bytes(grads), _unique_bytes(moments)


def parity(rank, world, data, out):
    params = _tree(data)
    table = torch.from_numpy(data["table"].astype(np.int64))
    res = {"losses": {}, "sizes": {}, "rows": {}}
    arrays = {}
    for label, arm, remat in ARMS:
        strat = _strategy(arm, remat)
        cfg = get_config("tinygpt", "S", S, dropout=0.0, compute_dtype=torch.float32,
                         attention_impl="flash", remat=strat.remat)
        mesh = make_mesh()
        model = TinyGPT(cfg, mesh=mesh)
        bridge.load_jax_params(model, params)
        model, opt = tstrat.apply_strategy(model, strat, mesh)
        step_fn = TrainStep(model, opt, grad_accum=ACCUM, micro_batch=MICRO, seed=0,
                            device=CPU, mesh=mesh)
        losses = []
        for step in range(STEPS):
            losses.append(step_fn(table, step).item())
            got = bridge.export_params(model)
            if rank == 0:
                arrays[f"{label}.{step}.wte"] = got["wte"]
                for leaf in sorted(got["blocks"]):
                    arrays[f"{label}.{step}.blocks.{leaf}"] = got["blocks"][leaf]
                for leaf in sorted(k for k in got if k not in ("wte", "blocks")):
                    arrays[f"{label}.{step}.{leaf}"] = got[leaf]
        res["losses"][label] = losses
        res["sizes"][label] = {
            "param_local": sum(_local(p).numel() for p in model.parameters()),
            "param_global": sum(p.numel() for p in model.parameters()),
            "moments": sum(_local(st["exp_avg"]).numel() for st in opt.adamw.state.values()),
            "leaf_shapes": [list(p.shape) for p in model.parameters()],
        }
        if remat is None or remat == "none":
            row = run_benchmark(strategy=arm, tier="S", seq_len=S, steps=3, warmup_steps=1,
                                per_device_batch=MICRO, grad_accum=ACCUM, device="cpu",
                                world_size=world)
            res["rows"][arm] = row.to_dict()
    np.savez(f"{out}.rank{rank}.npz", **arrays)
    return res


def held():
    res = {}
    for family in ("tinygpt", "llama"):
        for arm in sorted(tstrat.STRATEGIES):
            strat = _strategy(arm, "none")
            cfg = get_config(family, "S", S, compute_dtype=torch.float32, attention_impl="flash",
                             dropout=0.0)
            mesh = make_mesh()
            model = TinyGPT(cfg, mesh=mesh)
            model.init_weights(torch.Generator().manual_seed(0))
            est = memory.estimate_hbm(cfg, strat, mesh, MICRO, S)
            model, opt = tstrat.apply_strategy(model, strat, mesh)
            table = torch.randint(0, cfg.vocab_size, (8, S),
                                  generator=torch.Generator().manual_seed(1))
            TrainStep(model, opt, grad_accum=ACCUM, micro_batch=MICRO, seed=0, device=CPU,
                      mesh=mesh)(table, 0)
            res[f"{family}.{arm}"] = {"held": list(held_bytes(model, opt)),
                                      "estimate": [est.params, est.grads, est.opt_state]}
    return res


def main():
    rank, world, port, inputs, out, mode = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    assert rt.setup_distributed(num_processes=world, process_id=rank, master_port=int(port),
                                device="cpu")
    try:
        res = parity(rank, world, np.load(inputs), out) if mode == "parity" else held()
    finally:
        rt.cleanup_distributed()
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
