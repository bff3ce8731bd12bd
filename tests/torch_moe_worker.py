"""One rank of the expert-parallel checks over gloo on the CPU: the helper of
``tests/test_torch_moe_parallel.py``, which holds no test itself and
imports torch and the port only.

    python tests/torch_moe_worker.py RANK WORLD PORT INPUTS OUT MODE

``INPUTS`` holds the JAX params (tier S, 4 experts: ``wte``,
``blocks.moe_w1``, ...) and the batch table. ``MODE`` is a geometry of
``GEOMETRIES``: (data, expert) widths whose product is WORLD. For each arm of
``ARMS[WORLD]``, tier S MoE at S 64, fp32 compute, dropout 0, per-device
batch 1 x accum 2, loaded from the JAX params with the routers scaled by
``ROUTER_SCALE`` (each rank keeps its experts),
laid out by ``apply_strategy`` and trained 3 steps by ``TrainStep``: every
step's loss and the params after the last step gathered back to JAX's
leaves (rank 0). Then, under ddp and zero2 (and fsdp at WORLD 4), one
micro-batch's gradient from the same load: the clip's global norm
(``Optimizer._clip_norm``), and under ddp every leaf's gradient after the
arm's reduction, experts gathered over ``expert`` (rank 0). At the ep-2
geometries the gradients also of the model at ``router_aux_coef`` 0. At
(1, 2) also MoE beside a ``model`` and a ``seq`` axis on the group against
the same steps in one process, and a ``run_benchmark`` row at
``expert_parallel`` 2.

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

from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT, get_config
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import make_mesh
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.runtime import distributed as rt
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark
from distributed_llm_training_benchmark_framework_tpu_torch.train.step import TrainStep


S, MICRO, ACCUM, STEPS, EXPERTS = 64, 1, 2, 3, 4
# The training runs scale the routers of the JAX init by this
# (``tests/test_torch_moe_parallel.py`` says why); the gradients are taken
# at the init itself.
ROUTER_SCALE = 25.0
# mode -> (data, expert) widths.
GEOMETRIES = {"ep2": (1, 2), "dp2ep2": (2, 2), "dp2": (2, 1)}
ARMS = {2: ("ddp", "zero2"), 4: ("ddp", "fsdp", "zero2", "zero3")}
GRAD_ARMS = {2: ("ddp", "zero2"), 4: ("ddp", "fsdp", "zero2")}
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


def config(**kw):
    kw.setdefault("attention_impl", "reference")
    return get_config("tinygpt", "S", S, dropout=0.0, compute_dtype=torch.float32,
                      n_experts=EXPERTS, **kw)


def strategy(arm):
    return dataclasses.replace(tstrat.get_strategy(arm), precision="f32", remat="none")


def tree(data):
    params = {"blocks": {}}
    for key in data.files:
        if key.startswith("blocks."):
            params["blocks"][key.split(".", 1)[1]] = data[key]
        elif key != "table":
            params[key] = data[key]
    return params


def scaled(params):
    """The training runs' init: the routers scaled by ``ROUTER_SCALE``."""
    return {**params, "blocks": {**params["blocks"],
                                 "router": params["blocks"]["router"] * ROUTER_SCALE}}


def flat(label, params):
    out = {f"{label}.{k}": v for k, v in params.items() if k != "blocks"}
    out.update({f"{label}.blocks.{k}": v for k, v in params["blocks"].items()})
    return out


def mesh_of(ep):
    return make_mesh((ep,), ("expert",)) if ep > 1 else make_mesh()


def laid_out(arm, ep, params, **kw):
    mesh = mesh_of(ep)
    model = TinyGPT(config(**kw), mesh=mesh)
    bridge.load_jax_params(model, params)
    model, opt = tstrat.apply_strategy(model, strategy(arm), mesh)
    return mesh, model, opt


def gradients(model, opt, mesh, table):
    """One micro-batch (this member's row of rows 0..dp*ep) through the
    arm's reduction: (the clip's norm, every leaf's gradient gathered to
    JAX's leaves, or None where the arm keeps no whole gradient)."""
    member, members = mesh.batch_shard
    opt.zero_grad()
    with opt.sync_context(last=True):
        micro = table[member:member + 1]
        _, loss = model(micro, micro, batch_offset=member, global_batch=members)
        loss.backward()
    opt.finish_grads(1)
    norm = opt._clip_norm().item()
    if not isinstance(opt, tstrat._DDPOptimizer):
        return norm, None
    inner = model.module
    twin = TinyGPT(inner.config, mesh=mesh)
    with torch.no_grad():
        for t, p in zip(twin.parameters(), inner.parameters()):
            t.copy_(p.grad)
    return norm, bridge.export_params(twin)


def composed(params, table):
    """MoE beside a ``model`` or a ``seq`` axis over the two ranks: {axis:
    (3 zero2 steps' losses there, the same steps in this process with no
    group)}, from ``scaled(params)``; the layers route the global
    micro-batch, as JAX's einsum form does."""
    out = {}
    for axis, kw in (("model", {}), ("seq", dict(attention_impl="ring"))):
        losses = []
        for mesh in (make_mesh((2,), (axis,)), None):
            model = TinyGPT(config(**kw), mesh=mesh)
            bridge.load_jax_params(model, scaled(params))
            model, opt = tstrat.apply_strategy(model, strategy("zero2"), mesh)
            step_fn = TrainStep(model, opt, grad_accum=ACCUM, micro_batch=MICRO, seed=0,
                                device=CPU, mesh=mesh)
            losses.append([step_fn(table, step).item() for step in range(STEPS)])
        out[axis] = losses
    return out


def main():
    rank, world, port, inputs, out, mode = sys.argv[1:7]
    rank, world = int(rank), int(world)
    dp, ep = GEOMETRIES[mode]
    assert dp * ep == world
    torch.set_num_threads(1)
    assert rt.setup_distributed(num_processes=world, process_id=rank, master_port=int(port),
                                device="cpu")
    data = np.load(inputs)
    params, table = tree(data), torch.from_numpy(data["table"].astype(np.int64))
    res = {"losses": {}, "norms": {}, "batch_shard": None}
    arrays = {}
    try:
        for arm in ARMS[world]:
            mesh, model, opt = laid_out(arm, ep, scaled(params))
            res["batch_shard"] = list(mesh.batch_shard)
            step_fn = TrainStep(model, opt, grad_accum=ACCUM, micro_batch=MICRO, seed=0,
                                device=CPU, mesh=mesh)
            res["losses"][arm] = [step_fn(table, step).item() for step in range(STEPS)]
            got = bridge.export_params(model)
            if rank == 0:
                arrays.update(flat(arm, got))
        for arm in GRAD_ARMS[world]:
            mesh, model, opt = laid_out(arm, ep, params)
            res["norms"][arm], grads = gradients(model, opt, mesh, table)
            if rank == 0 and grads is not None:
                arrays.update(flat(f"grad.{arm}", grads))
        if ep > 1:
            mesh, model, opt = laid_out("ddp", ep, params, router_aux_coef=0.0)
            _, grads = gradients(model, opt, mesh, table)
            if rank == 0:
                arrays.update(flat("grad.no_aux", grads))
        if (dp, ep) == (1, 2):
            res["composed"] = composed(params, table)
            res["row"] = run_benchmark(strategy="zero2", tier="S", seq_len=S, steps=3,
                                       warmup_steps=1, per_device_batch=MICRO, grad_accum=ACCUM,
                                       device="cpu", world_size=world, n_experts=EXPERTS,
                                       expert_parallel=ep).to_dict()
    finally:
        rt.cleanup_distributed()
    np.savez(f"{out}.rank{rank}.npz", **arrays)
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
