"""One rank of the MoE-beside-every-axis checks over gloo on the CPU: the
helper of ``tests/test_torch_moe_composed.py``, which holds no test itself
and imports torch and the port only.

    python tests/torch_moe_composed_worker.py RANK WORLD PORT INPUTS OUT MODE

``INPUTS`` holds the JAX params (tier S, 4 experts: ``wte``,
``blocks.moe_w1``, ...) and the batch table. ``MODE`` is a geometry of
``GEOMETRIES``: (data, seq, model, pipe, expert) widths whose product is
WORLD, the ``moe_dispatch`` and the attention. For each arm of the mode's
``ARMS``, tier S MoE at S 64, fp32 compute, dropout 0, per-device batch 1 x
accum 2 (under ``pipe`` the gpipe schedule's M 2), loaded from the JAX
params (each rank keeps its experts, its F/tp columns and its stage's
layers) and laid out by ``apply_strategy``: step 0's gradient after the
arm's reduction (``TrainStep.accumulate``) and its clip norm
(``Optimizer._clip_norm``), under ddp every leaf of it gathered to JAX's
leaves (rank 0); then, from the params with the routers scaled by
``ROUTER_SCALE``, 3 steps by ``TrainStep``: every step's loss and the
params after the last step gathered back to JAX's leaves (rank 0); and at
those params the loop's MoE overflow diagnostic.

Writes ``OUT.rank<RANK>.npz`` and ``OUT.rank<RANK>.json``.
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
import torch.distributed as dist

from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT, get_config
from distributed_llm_training_benchmark_framework_tpu_torch.models.tinygpt import (
    moe_overflow_fraction,
)
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import make_mesh
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.parallel.pipeline import Pipeline
from distributed_llm_training_benchmark_framework_tpu_torch.runtime import distributed as rt
from distributed_llm_training_benchmark_framework_tpu_torch.train.step import TrainStep

S, MICRO, ACCUM, STEPS, EXPERTS = 64, 1, 2, 3, 4
# The training runs scale the routers of the JAX init by this
# (``tests/test_torch_moe_parallel.py`` says why); the gradients are taken
# at the init itself.
ROUTER_SCALE = 25.0
AXES5 = ("data", "seq", "model", "pipe", "expert")
# mode -> ((data, seq, model, pipe, expert), moe_dispatch, attention)
GEOMETRIES = {
    "sp2": ((1, 2, 1, 1, 1), "auto", "ring"),
    "tp2": ((1, 1, 2, 1, 1), "auto", "reference"),
    "ep2": ((1, 1, 1, 1, 2), "einsum", "reference"),
    "dp2ep2": ((2, 1, 1, 1, 2), "einsum", "reference"),
    "tp2ep2": ((1, 1, 2, 1, 2), "auto", "reference"),
    "pp2ep2": ((1, 1, 1, 2, 2), "auto", "reference"),
    "sp2pp2": ((1, 2, 1, 2, 1), "auto", "ring"),
}
ARMS = {mode: ("ddp", "fsdp", "zero2", "zero3") if mode == "dp2ep2" else ("ddp", "zero2")
        for mode in GEOMETRIES}
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]


def spawn_ranks(world, inputs, out, mode):
    """Start this script on ``world`` gloo ranks on localhost."""
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


def widths(mode):
    return dict(zip(AXES5, GEOMETRIES[mode][0]))


def config(mode):
    _, dispatch, attention = GEOMETRIES[mode]
    return get_config("tinygpt", "S", S, dropout=0.0, compute_dtype=torch.float32,
                      attention_impl=attention, n_experts=EXPERTS, moe_dispatch=dispatch)


def tree(data):
    params = {"blocks": {}}
    for key in data.files:
        if key.startswith("blocks."):
            params["blocks"][key.split(".", 1)[1]] = data[key]
        elif key != "table":
            params[key] = data[key]
    return params


def scaled(params):
    """The runs' init: the routers scaled by ``ROUTER_SCALE``."""
    return {**params, "blocks": {**params["blocks"],
                                 "router": params["blocks"]["router"] * ROUTER_SCALE}}


def flat(label, params):
    out = {f"{label}.{k}": v for k, v in params.items() if k != "blocks"}
    out.update({f"{label}.blocks.{k}": v for k, v in params["blocks"].items()})
    return out


def mesh_of(mode):
    axes = [(a, w) for a, w in widths(mode).items() if a != "data" and w > 1]
    return make_mesh(tuple(w for _, w in axes), tuple(a for a, _ in axes))


def laid_out(mode, arm, params):
    """(mesh, model as the arm returns it, its optimizer, the train step)."""
    mesh = mesh_of(mode)
    model = TinyGPT(config(mode), mesh=mesh)
    bridge.load_jax_params(model, params)
    model, opt = tstrat.apply_strategy(
        model, dataclasses.replace(tstrat.get_strategy(arm), precision="f32", remat="none"),
        mesh)
    pipe = Pipeline("gpipe", mesh, ACCUM, CPU) if mesh.size("pipe") > 1 else None
    step_fn = TrainStep(model, opt, grad_accum=ACCUM, micro_batch=MICRO, seed=0, device=CPU,
                        mesh=mesh, pipeline=pipe)
    return mesh, model, opt, step_fn


def gradient(mode, arm, params, table):
    """Step 0's gradient after the arm's reduction: (the clip's norm, every
    leaf gathered to JAX's leaves under ddp, else None)."""
    mesh, model, opt, step_fn = laid_out(mode, arm, params)
    step_fn.accumulate(table, 0)
    norm = opt._clip_norm().item()
    if arm != "ddp":
        return norm, None
    inner = model.module
    twin = TinyGPT(inner.config, mesh=mesh)
    with torch.no_grad():
        for t, p in zip(twin.parameters(), inner.parameters()):
            t.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    return norm, bridge.export_params(twin, pipe_group=mesh.pipe_group)


def overflow(mode, params, table):
    """The loop's MoE overflow diagnostic on step 0's first micro-batch
    (this rank's rows and columns), at ``params``."""
    _, model, _, step_fn = laid_out(mode, "ddp", params)
    rows = step_fn.rows(table, 0)[0]
    return moe_overflow_fraction(model.module, rows, step_fn.member * MICRO,
                                 MICRO * step_fn.members, step_fn.pipeline).item()


def main():
    rank, world, port, inputs, out, mode = sys.argv[1:7]
    rank, world = int(rank), int(world)
    assert int(np.prod(GEOMETRIES[mode][0])) == world
    torch.set_num_threads(1)
    assert rt.setup_distributed(num_processes=world, process_id=rank, master_port=int(port),
                                device="cpu")
    data = np.load(inputs)
    params, table = tree(data), torch.from_numpy(data["table"].astype(np.int64))
    res = {"losses": {}, "norms": {}}
    arrays = {}
    try:
        for arm in ARMS[mode]:
            res["norms"][arm], grads = gradient(mode, arm, params, table)
            if rank == 0 and grads is not None:
                arrays.update(flat(f"grad.{arm}", grads))
            mesh, model, _, step_fn = laid_out(mode, arm, scaled(params))
            res["losses"][arm] = [step_fn(table, step).item() for step in range(STEPS)]
            got = bridge.export_params(model, pipe_group=mesh.pipe_group)
            if rank == 0:
                arrays.update(flat(arm, got))
        res["overflow"] = overflow(mode, scaled(params), table)
        res["members"] = list(mesh.batch_shard)
        res["shapes"] = {name: list(p.shape) for name, p in TinyGPT(
            config(mode), mesh=mesh).named_parameters() if ".experts." in name}
        dist.barrier()
    finally:
        rt.cleanup_distributed()
    np.savez(f"{out}.rank{rank}.npz", **arrays)
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
