"""One rank of the scan layer loop over gloo on the CPU: the helper of
``tests/test_torch_scan.py``, which holds no test itself and imports torch
and the port only.

    python tests/torch_scan_worker.py RANK WORLD PORT INPUTS OUT GEOMETRY

``INPUTS`` is an .npz per family of the JAX params (``<family>.wte``,
``<family>.blocks.wq``, ...; ``llama4`` the 4-layer Llama, ``tinygpt_moe``
TinyGPT with 4 experts) and the batch
table (``table``). ``GEOMETRY`` names an entry of ``GEOMETRIES``: its mesh,
family, config and arms. For each arm the worker builds the model from the
JAX params, lays it out by ``apply_strategy`` and trains ``STEPS`` steps by
``TrainStep`` (per-device batch 1 x accum 2, fp32 compute, dropout 0), once
under the unrolled loop and once under the scan loop, and records every
step's loss under both; under the scan loop also the exported params after
the last step (rank 0) and the bytes this rank holds in each stacked leaf.
Under zero2 it records whether the stacked leaves hold a gradient of their
own (its buckets take the layers' gradients). The ``dp2`` geometry also
saves checkpoints under one loop and resumes them under the other through
``run_benchmark`` (``CKPT_ARMS``).

Writes ``OUT.rank<RANK>.npz`` and ``OUT.rank<RANK>.json``.
"""

import contextlib
import dataclasses
import io
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

S, MICRO, ACCUM, STEPS = 32, 1, 2, 3
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
AXES = ("data", "seq", "model")
# (label, arm, strategy change): zero3 under remat "full" (the gather
# inside the checkpoint; fsdp runs the same layout without remat), and the
# serial host-offload arm over zero2.
ARMS = {
    "ddp": ("ddp", {}), "fsdp": ("fsdp", {}), "zero2": ("zero2", {}),
    "zero3": ("zero3", {"remat": "none"}), "zero3_full": ("zero3", {"remat": "full"}),
    "offload": ("zero2", {"offload_opt_state": True}),
}
# name -> (world, mesh shape over AXES, params key, config change, arms).
GEOMETRIES = {
    "dp2": (2, (2, 1, 1), "tinygpt", {}, ("ddp", "fsdp", "zero2", "zero3_full", "offload")),
    "fsdp_tp": (8, (4, 1, 2), "llama", {}, ("fsdp",)),
    "tp2": (4, (2, 1, 2), "llama4", {"n_layer": 4}, ("ddp", "fsdp", "zero2")),
    "cmm": (2, (1, 1, 2), "llama", {"tp_collective_matmul": True}, ("ddp", "zero2")),
    "seq": (2, (1, 2, 1), "tinygpt", {"attention_impl": "ring"}, ("ddp", "fsdp", "zero2")),
    "moe": (2, (2, 1, 1), "tinygpt_moe", {"n_experts": 4}, ("ddp", "fsdp", "zero2")),
}
CKPT_ARMS = ("zero2", "fsdp")


def spawn_ranks(world, inputs, out, geometry):
    """Start this script on ``world`` gloo ranks on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    return [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(port), str(inputs), str(out),
         geometry], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def wait_ranks(procs):
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]


def _tree(data, key):
    params = {"blocks": {}}
    for name in data.files:
        if not name.startswith(key + "."):
            continue
        leaf = name[len(key) + 1:]
        if leaf.startswith("blocks."):
            params["blocks"][leaf.split(".", 1)[1]] = data[name]
        else:
            params[leaf] = data[name]
    return params


def _config(family, change, scan):
    kw = dict(dropout=0.0, compute_dtype=torch.float32, attention_impl="reference",
              scan_layers=scan)
    kw.update(change)
    if kw.get("n_experts"):
        kw["n_experts"] = int(kw["n_experts"])
    return get_config("llama" if family.startswith("llama") else "tinygpt", "S", S, **kw)


def _train(family, change, label, scan, params, table, mesh_shape):
    arm, strat_change = ARMS[label]
    strategy = dataclasses.replace(tstrat.get_strategy(arm), precision="f32", **strat_change)
    mesh = make_mesh(mesh_shape, AXES)
    cfg = _config(family, change, scan)
    if strategy.offload_opt_state:
        cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    cfg = dataclasses.replace(cfg, remat=strat_change.get("remat", "none"))
    model = TinyGPT(cfg, mesh=mesh)
    bridge.load_jax_params(model, params)
    model, opt = tstrat.apply_strategy(model, strategy, mesh)
    step_fn = TrainStep(model, opt, grad_accum=ACCUM, micro_batch=MICRO, seed=0, device=CPU,
                        mesh=mesh)
    losses = [step_fn(table, step).item() for step in range(STEPS)]
    return model, opt, losses


def _checkpoints(root):
    """Per arm of ``CKPT_ARMS``: the straight unrolled run's losses, and
    each cross-loop run's (3 steps under one loop, saved, then resumed to
    6 under the other)."""
    out = {}
    kw = dict(tier="S", seq_len=S, warmup_steps=1, per_device_batch=1, grad_accum=2,
              device="cpu", dataset_size=16, telemetry=False, dropout=0.1)
    for arm in CKPT_ARMS:
        straight = []
        with contextlib.redirect_stdout(io.StringIO()):
            run_benchmark(strategy=arm, steps=6, loss_log=straight, **kw)
        out[arm] = {"straight": straight}
        for first, then in (("scan", "unrolled"), ("unrolled", "scan")):
            ck = os.path.join(root, f"{arm}_{first}")
            losses = []
            with contextlib.redirect_stdout(io.StringIO()):
                run_benchmark(strategy=arm, steps=3, loss_log=losses, layer_loop=first,
                              checkpoint_dir=ck, checkpoint_every=3, **kw)
                run_benchmark(strategy=arm, steps=6, loss_log=losses, layer_loop=then,
                              checkpoint_dir=ck, checkpoint_every=3, resume=True, **kw)
            out[arm][f"{first}->{then}"] = losses
    return out


def main():
    rank, world, port, inputs, out, geometry = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    assert rt.setup_distributed(num_processes=world, process_id=rank, master_port=int(port),
                                device="cpu")
    n_world, mesh_shape, key, change, arms = GEOMETRIES[geometry]
    assert n_world == world
    data = np.load(inputs)
    params = _tree(data, key)
    table = torch.from_numpy(data["table"].astype(np.int64))
    record = {"losses": {}, "stacked_bytes": {}, "zero2_stacked_grads": None}
    arrays = {}
    for label in arms:
        _, _, unrolled = _train(key, change, label, False, params, table, mesh_shape)
        model, opt, scan = _train(key, change, label, True, params, table, mesh_shape)
        record["losses"][label] = {"unrolled": unrolled, "scan": scan}
        inner = getattr(model, "module", model)
        record["stacked_bytes"][label] = {
            leaf: inner.blocks.stacked(leaf).numel() * inner.blocks.stacked(leaf).element_size()
            for leaf in inner.blocks.leaf_names}
        if label == "zero2":
            record["zero2_stacked_grads"] = [inner.blocks.stacked(leaf).grad is not None
                                             for leaf in inner.blocks.leaf_names]
        if label == "offload":
            continue  # bf16 parameters: held to the unrolled run only
        tree = bridge.export_params(model)
        if rank == 0:
            arrays.update({f"{label}.{k}": v for k, v in tree.items() if k != "blocks"})
            arrays.update({f"{label}.blocks.{k}": v for k, v in tree["blocks"].items()})
    if geometry == "dp2":
        record["checkpoints"] = _checkpoints(f"{out}_ckpt")
    Path(f"{out}.rank{rank}.json").write_text(json.dumps(record))
    if rank == 0:
        np.savez(f"{out}.rank{rank}.npz", **arrays)
    rt.cleanup_distributed()


if __name__ == "__main__":
    main()
