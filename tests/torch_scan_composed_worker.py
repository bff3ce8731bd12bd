"""One rank of the scan layer loop beside ``pipe`` and ``expert`` over gloo
on the CPU: the helper of ``tests/test_torch_scan_pipe.py`` and
``tests/test_torch_scan_moe.py``, which holds no test itself and imports
torch and the port only.

    python tests/torch_scan_composed_worker.py RANK WORLD PORT INPUTS OUT MODE

``INPUTS`` holds the JAX params of ``CONFIGS`` (``l4.wte``,
``moe.blocks.router``, ...; the MoE routers already scaled by the test) and
the batch table. ``MODE`` names a geometry of ``GEOMETRIES``: (data, model,
pipe, expert) widths whose product is WORLD, the configuration, and its
runs. Every run is tier S at S 64 with 4 layers, fp32 compute, reference
attention, per-device batch 1 x accum 4 (under ``pipe`` the schedule's M
4), loaded from the JAX params and laid out by ``apply_strategy``. Each run
goes once under the unrolled loop and once under the scan loop, in this
process: step 0's gradient after the arm's reduction
(``TrainStep.accumulate``) gathered to JAX's leaves by global layer (every
layout: zero2's bucket shards, FSDP2's and the scan arm's ``data`` shares,
the ``model`` / ``expert`` / ``pipe`` parts), the clip's norm, the messages
the schedule sent; then ``STEPS`` steps by ``TrainStep``: every step's loss
and the params after the last step gathered likewise. The two loops are
compared here, leaf by leaf with ``np.array_equal``; the record names the
leaves that differ. Under zero2 beside ``pipe`` the scan run also counts
the block buckets whose reduce-scatter had started when the schedule ended,
and the bytes this rank holds of each stacked leaf; under ddp the names DDP
ignores (the expert leaves, which the arm reduces itself); under zero2 and
scan whether ``bitflip@0`` reaches the shards the optimizer updates.

Rank 0 keeps the scan run's gradient and final params of every run
(``<run>.grad.<leaf>``, ``<run>.params.<leaf>``) for the JAX comparisons.
Geometries with ``CKPT`` runs also save a checkpoint under one loop through
``run_benchmark`` and resume it under the other.

Writes ``OUT.rank<RANK>.npz`` (rank 0) and ``OUT.rank<RANK>.json``.
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
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.faults.injection import (
    BITFLIP_VALUE,
    FaultInjector,
    parse_fault_spec,
)
from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT, get_config
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import make_mesh
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.parallel.pipeline import Pipeline
from distributed_llm_training_benchmark_framework_tpu_torch.runtime import distributed as rt
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark
from distributed_llm_training_benchmark_framework_tpu_torch.train.step import TrainStep

S, MICRO, ACCUM, STEPS, EXPERTS, V, N_LAYER = 64, 1, 4, 2, 4, 2, 4
AXES4 = ("data", "model", "pipe", "expert")
# label -> experts
CONFIGS = {"l4": 0, "moe": EXPERTS}
# run -> (arm, schedule or None, strategy change, config change). zero3
# runs under remat "full" (the scan arm's gather inside the checkpoint,
# and, under 1f1b, inside the stage's recompute).
RUNS = {
    **{f"{arm}.{s}": (arm, s, {}, {}) for arm in ("ddp", "zero2", "fsdp")
       for s in ("gpipe", "1f1b", "interleaved")},
    "zero3.1f1b": ("zero3", "1f1b", {"remat": "full"}, {}),
    "zero2.interleaved.dropout": ("zero2", "interleaved", {}, {"dropout": 0.1}),
    **{f"{arm}.{d}": (arm, None, {}, {"moe_dispatch": "auto" if d == "index" else "einsum"})
       for arm in ("ddp", "zero2", "fsdp", "zero3") for d in ("index", "einsum")},
}
# mode -> ((data, model, pipe, expert), configuration, runs)
GEOMETRIES = {
    "pp2": ((1, 1, 2, 1), "l4", ("ddp.gpipe", "ddp.1f1b", "ddp.interleaved", "zero2.gpipe",
                                 "zero2.1f1b", "zero2.interleaved",
                                 "zero2.interleaved.dropout")),
    "dp2pp2": ((2, 1, 2, 1), "l4", ("zero2.gpipe", "zero2.1f1b", "zero2.interleaved",
                                    "fsdp.gpipe", "fsdp.interleaved", "zero3.1f1b")),
    "tp2pp2": ((1, 2, 2, 1), "l4", ("zero2.gpipe", "ddp.interleaved")),
    "ep2": ((1, 1, 1, 2), "moe", ("ddp.index", "zero2.index", "fsdp.index", "zero2.einsum",
                                  "fsdp.einsum")),
    "dp2ep2": ((2, 1, 1, 2), "moe", ("zero2.index", "fsdp.index", "zero3.index")),
    "tp2ep2": ((1, 2, 1, 2), "moe", ("ddp.index", "zero2.index")),
    "pp2ep2": ((1, 1, 2, 2), "moe", ("ddp.gpipe", "zero2.gpipe", "fsdp.gpipe")),
}
# mode -> the run_benchmark arguments of its checkpoint crossing, and the
# (first loop, then loop) it crosses
CKPT = {
    "pp2": (dict(pipeline_parallel=2), ("unrolled", "scan")),
    "ep2": (dict(n_experts=EXPERTS, expert_parallel=2), ("scan", "unrolled")),
}
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


def world_of(mode):
    return int(np.prod(GEOMETRIES[mode][0]))


def config(label, scan, **change):
    kw = dict(n_layer=N_LAYER, dropout=0.0, compute_dtype=torch.float32,
              attention_impl="reference", n_experts=CONFIGS[label], scan_layers=scan)
    kw.update(change)
    return get_config("tinygpt", "S", S, **kw)


def tree(data, label):
    params = {"blocks": {}}
    for key in data.files:
        if not key.startswith(label + "."):
            continue
        key = key[len(label) + 1:]
        if key.startswith("blocks."):
            params["blocks"][key.split(".", 1)[1]] = data[f"{label}.{key}"]
        else:
            params[key] = data[f"{label}.{key}"]
    return params


def flat(prefix, params):
    out = {f"{prefix}.{k}": v for k, v in params.items() if k != "blocks"}
    out.update({f"{prefix}.blocks.{k}": v for k, v in params["blocks"].items()})
    return out


def mesh_of(mode):
    axes = [(a, w) for a, w in zip(AXES4, GEOMETRIES[mode][0]) if a != "data" and w > 1]
    return make_mesh(tuple(w for _, w in axes), tuple(a for a, _ in axes))


def local_grads(model, opt):
    """{unrolled port name: this rank's ``model`` / ``expert`` / stage part
    of its gradient after the arm's reduction, whole over ``data``}."""
    inner = getattr(model, "module", model)
    out = {}
    if isinstance(opt, tstrat._Zero2Optimizer):
        for b in opt.buckets:
            whole = b.shard_grad.new_empty(b.shard_grad.numel() * opt.dp)
            dist.all_gather_into_tensor(whole, b.shard_grad, group=opt.group)
            offset = 0
            for name, p in zip(b.names, b.params):
                out[name] = whole[offset:offset + p.numel()].view(p.shape)
                offset += p.numel()
        return out
    for name, p in inner.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if isinstance(g, DTensor):
            g = g.full_tensor()
        if inner.scan and name.startswith("blocks."):
            leaf = name.split(".", 1)[1]
            for i in range(len(inner.blocks)):
                out[f"blocks.{i}.{leaf}"] = inner.blocks.unshard(leaf, g[i])
        else:
            out[name] = g
    return out


def exported_grads(model, opt, mesh, virtual):
    """Step 0's gradient as JAX's leaves (global layers in order), on every
    rank: this rank's parts in an unrolled twin, exported."""
    inner = getattr(model, "module", model)
    grads = local_grads(model, opt)
    twin = TinyGPT(dataclasses.replace(inner.config, scan_layers=False), mesh=mesh,
                   virtual_stages=virtual)
    with torch.no_grad():
        for name, p in twin.named_parameters():
            p.copy_(grads[name])
    return bridge.export_params(twin, pipe_group=mesh.pipe_group)


def laid_out(mode, run, scan, params):
    """(mesh, model as the arm returns it, its optimizer, the train step)."""
    _, label, _ = GEOMETRIES[mode]
    arm, schedule, strat_change, cfg_change = RUNS[run]
    strat = dataclasses.replace(tstrat.get_strategy(arm), **{
        "precision": "f32", "remat": "none", **strat_change})
    mesh = mesh_of(mode)
    virtual = V if schedule == "interleaved" else 1
    model = TinyGPT(config(label, scan, remat=strat.remat, **cfg_change), mesh=mesh,
                    virtual_stages=virtual)
    bridge.load_jax_params(model, params)
    model, opt = tstrat.apply_strategy(model, strat, mesh)
    pipe = Pipeline(schedule, mesh, ACCUM, CPU, V) if schedule is not None else None
    step_fn = TrainStep(model, opt, grad_accum=ACCUM, micro_batch=MICRO, seed=0, device=CPU,
                        mesh=mesh, pipeline=pipe)
    return mesh, model, opt, step_fn, virtual


def one_loop(mode, run, scan, params, table):
    """One loop's run: (record, step 0's gradient tree, the final params)."""
    mesh, model, opt, step_fn, virtual = laid_out(mode, run, scan, params)
    rec = {}
    if isinstance(opt, tstrat._Zero2Optimizer) and step_fn.pipeline is not None:
        finish = opt.finish_grads

        def counted(grad_accum):
            blocks = [b for b in opt.buckets if b.key]
            rec["launched"] = [sum(b.work is not None for b in blocks), len(blocks)]
            finish(grad_accum)

        opt.finish_grads = counted
    inner = getattr(model, "module", model)
    if scan:
        rec["held"] = {leaf: inner.blocks.stacked(leaf).numel() * 4
                       for leaf in inner.blocks.leaf_names}
    if hasattr(model, "parameters_to_ignore"):
        rec["ddp_ignores"] = sorted(model.parameters_to_ignore)
    step_fn.accumulate(table, 0)
    rec["norm"] = opt._clip_norm().item()
    if step_fn.pipeline is not None:
        rec["sent"] = list(step_fn.pipeline.transport.sent)
    grads = exported_grads(model, opt, mesh, virtual)
    _, model, opt, step_fn, _ = laid_out(mode, run, scan, params)
    rec["losses"] = [step_fn(table, step).item() for step in range(STEPS)]
    final = bridge.export_params(model, pipe_group=mesh.pipe_group)
    if scan and RUNS[run][0] == "zero2":
        rec["bitflip"] = bitflip_reaches_the_shards(mode, run, params)
    return rec, grads, final


def bitflip_reaches_the_shards(mode, run, params):
    """zero2 under the scan loop: after ``bitflip@0`` (the injector given
    the optimizer, as the loop gives it), each layer bucket's shard on this
    rank equals its share of the stacked leaves, the flipped element
    included, and one rank holds that element."""
    _, model, opt, _, _ = laid_out(mode, run, True, params)
    inner = getattr(model, "module", model)
    FaultInjector(parse_fault_spec("bitflip@0"), is_main=False,
                  rank=dist.get_rank()).corrupt_params(0, inner, opt)
    agree, flipped = True, 0
    for b, shard in zip(opt.buckets, opt.params):
        if b.flat is None:
            whole = torch.cat([p.reshape(-1) for p in b.params])
            mine = whole[opt.rank * shard.numel():(opt.rank + 1) * shard.numel()]
            agree &= torch.equal(shard[:mine.numel()], mine)
            flipped += int((shard == BITFLIP_VALUE).sum())
    return {"agree": agree, "flipped_here": flipped}


def differing(a, b):
    """The leaves of two JAX-shaped trees that are not equal bit for bit."""
    fa, fb = flat("", a), flat("", b)
    assert fa.keys() == fb.keys()
    return sorted(k[1:] for k in fa if not np.array_equal(fa[k], fb[k]))


def checkpoints(mode, root):
    """The straight run's losses and the cross-loop run's (3 steps under one
    loop, saved, then resumed to 6 under the other) through
    ``run_benchmark``: zero2, tier S, dropout 0.1."""
    extra, (first, then) = CKPT[mode]
    kw = dict(strategy="zero2", tier="S", seq_len=S, warmup_steps=1, per_device_batch=1,
              grad_accum=2, device="cpu", dataset_size=16, telemetry=False, dropout=0.1,
              world_size=dist.get_world_size(), **extra)
    straight, crossed = [], []
    ck = os.path.join(root, f"{first}_to_{then}")
    with contextlib.redirect_stdout(io.StringIO()):
        run_benchmark(steps=6, loss_log=straight, **kw)
        run_benchmark(steps=3, loss_log=crossed, layer_loop=first, checkpoint_dir=ck,
                      checkpoint_every=3, **kw)
        run_benchmark(steps=6, loss_log=crossed, layer_loop=then, checkpoint_dir=ck,
                      checkpoint_every=3, resume=True, **kw)
    return {"straight": straight, f"{first}->{then}": crossed}


def main():
    rank, world, port, inputs, out, mode = sys.argv[1:7]
    rank, world = int(rank), int(world)
    assert world_of(mode) == world
    torch.set_num_threads(1)
    assert rt.setup_distributed(num_processes=world, process_id=rank, master_port=int(port),
                                device="cpu")
    data = np.load(inputs)
    _, label, runs = GEOMETRIES[mode]
    params, table = tree(data, label), torch.from_numpy(data["table"].astype(np.int64))
    res = {"runs": {}, "stage": list(mesh_of(mode).pipe_shard)}
    arrays = {}
    try:
        for run in runs:
            rec_u, grads_u, final_u = one_loop(mode, run, False, params, table)
            rec_s, grads_s, final_s = one_loop(mode, run, True, params, table)
            res["runs"][run] = {"unrolled": rec_u, "scan": rec_s,
                                "grad_diff": differing(grads_u, grads_s),
                                "param_diff": differing(final_u, final_s)}
            if rank == 0:
                arrays.update(flat(f"{run}.grad", grads_s))
                arrays.update(flat(f"{run}.params", final_s))
        if mode in CKPT:
            res["checkpoints"] = checkpoints(mode, f"{out}_ckpt")
        dist.barrier()
    finally:
        rt.cleanup_distributed()
    if rank == 0:
        np.savez(f"{out}.rank{rank}.npz", **arrays)
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
