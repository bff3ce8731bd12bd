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
  and the world-``WORLD`` result row of ``run_benchmark`` for the arm. At
  WORLD 2 also each arm of ``OFFLOAD_ARMS`` under the serial host-offload
  arm (bf16 parameters, the JAX params rounded to bf16): every step's loss,
  the gathered fp32 masters after the last step (rank 0), and the world-2
  ``run_benchmark`` row of zero2 with offload. At WORLD 2 zero2 also runs
  over ``SingleBufferZero2`` (the arm's earlier form, one flat buffer per
  dtype reduce-scattered after the backward; kept here only as the per-block
  buckets' reference): every step's loss and params (rank 0); and one
  per-block zero2 step records, in order, each block's backward start (a
  hook on its output's gradient) and each reduce-scatter the arm launches,
  with its bucket and whether autograd's backward was running;
- ``bytes``: for each arm and family, and each of f32 parameters, bf16
  parameters and host offload, the arm at tier S (seed weights), one step,
  then the bytes this rank holds in params, grads and AdamW moments on its
  device (unique storages), beside ``utils.memory.estimate_hbm``'s.

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
# The serial host-offload arm over the group, and its limits against one
# process (``tests/test_torch_arms.py`` says why).
OFFLOAD_ARMS = ("ddp", "zero2", "zero3")
OFFLOAD_LOSS_RTOL, OFFLOAD_LR_SHARE, OFFLOAD_IN_SHARE = 5e-3, 2 ** -5, 0.99
# The bytes mode's parameter settings: {key suffix: strategy change}.
STATE_KINDS = {"": {}, ".bf16": {"param_dtype": "bf16"}, ".offload": {"offload_opt_state": True}}
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


def _strategy(arm, remat=None, **change):
    s = dataclasses.replace(tstrat.get_strategy(arm), precision="f32", **change)
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
    """Bytes of params, grads and AdamW moments this rank holds on its device
    (no moments there under host offload)."""
    params = list(model.parameters()) + opt.params
    grads = [p.grad for p in params if p.grad is not None]
    states = opt.adamw.state.values() if opt.adamw is not None else []
    moments = [st[k] for st in states for k in ("exp_avg", "exp_avg_sq")]
    return _unique_bytes(params), _unique_bytes(grads), _unique_bytes(moments)


def master_tree(model, opt, mesh):
    """The offload arm's fp32 host masters as a JAX-shaped numpy tree, whole
    leaves: zero2's flat shards all-gathered over ``data``, fsdp / zero3's
    DTensor shards gathered, tp shards gathered over ``model`` (by
    ``bridge.export_params`` of an fp32 twin of the model). Every rank of
    the group calls it."""
    inner = getattr(model, "module", model)
    views = opt.host.master_views
    if isinstance(opt, tstrat._Zero2Optimizer):
        values = []
        wholes = []
        for bucket, shard in zip(opt.buckets, views):
            whole = torch.empty(bucket.flat.numel(), dtype=torch.float32)
            torch.distributed.all_gather_into_tensor(whole, shard.contiguous(), group=opt.group)
            wholes.append((bucket.flat, whole))
        for p in inner.parameters():
            for flat, whole in wholes:
                off = (p.data_ptr() - flat.data_ptr()) // p.element_size()
                if 0 <= off < flat.numel():
                    values.append(whole[off:off + p.numel()].view(p.shape))
                    break
    else:
        values = []
        for p, v in zip(inner.parameters(), views):
            if isinstance(p, torch.distributed.tensor.DTensor):
                v = torch.distributed.tensor.DTensor.from_local(
                    v, p.device_mesh, p.placements, shape=p.shape, stride=p.stride()).full_tensor()
            values.append(v)
    twin = TinyGPT(dataclasses.replace(inner.config, param_dtype=torch.float32), mesh=mesh)
    with torch.no_grad():
        for t, v in zip(twin.parameters(), values):
            t.copy_(v)
    return bridge.export_params(twin)


class SingleBufferZero2(tstrat.Optimizer):
    """zero2 with one flat buffer per dtype, reduce-scattered once after the
    last micro-batch's backward (the arm before its per-block buckets)."""

    def __init__(self, strategy, model, group):
        dp, rank = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
        self.group, self.buckets, shards = group, [], []
        by_dtype = {}
        for p in model.parameters():
            by_dtype.setdefault(p.dtype, []).append(p)
        with torch.no_grad():
            for dtype, params in by_dtype.items():
                size = -(-sum(p.numel() for p in params) // dp)
                flat = torch.zeros(size * dp, dtype=dtype)
                grads = torch.zeros_like(flat)
                offset = 0
                for p in params:
                    k = p.numel()
                    flat[offset:offset + k].copy_(p.reshape(-1))
                    p.data = flat[offset:offset + k].view_as(p)
                    p.grad = grads[offset:offset + k].view_as(p)
                    offset += k
                shard = torch.nn.Parameter(flat[rank * size:(rank + 1) * size])
                shard.grad = torch.zeros(size, dtype=dtype)
                shards.append(shard)
                self.buckets.append((flat, grads, shard.grad))
        super().__init__(strategy, shards, norm_group=group)

    def zero_grad(self):
        for _, grads, _ in self.buckets:
            grads.zero_()

    @torch.no_grad()
    def finish_grads(self, grad_accum):
        for _, grads, shard_grad in self.buckets:
            torch.distributed.reduce_scatter_tensor(shard_grad, grads, group=self.group)
            shard_grad.div_(torch.distributed.get_world_size(self.group))
        super().finish_grads(grad_accum)

    def step(self):
        super().step()
        with torch.no_grad():
            for (flat, _, _), shard in zip(self.buckets, self.params):
                torch.distributed.all_gather_into_tensor(flat, shard, group=self.group)


def parity_config(remat="none"):
    return get_config("tinygpt", "S", S, dropout=0.0, compute_dtype=torch.float32,
                      attention_impl="flash", remat=remat)


def zero2_forms(params, table, arrays, rank):
    """zero2 over ``SingleBufferZero2``: per-step losses, params (rank 0)."""
    mesh = make_mesh()
    model = TinyGPT(parity_config(), mesh=mesh)
    bridge.load_jax_params(model, params)
    opt = SingleBufferZero2(_strategy("zero2"), model, mesh.data_group)
    step_fn = TrainStep(model, opt, grad_accum=ACCUM, micro_batch=MICRO, seed=0, device=CPU,
                        mesh=mesh)
    losses = []
    for step in range(STEPS):
        losses.append(step_fn(table, step).item())
        got = bridge.export_params(model)
        if rank == 0:
            arrays.update({f"zero2_single.{step}.{k}": v for k, v in got.items() if k != "blocks"})
            arrays.update({f"zero2_single.{step}.blocks.{k}": v
                           for k, v in got["blocks"].items()})
    return losses


def zero2_launch_order(params, table):
    """One per-block zero2 step: the events, in order (see the docstring)."""
    mesh = make_mesh()
    model = TinyGPT(parity_config(), mesh=mesh)
    bridge.load_jax_params(model, params)
    model, opt = tstrat.apply_strategy(model, _strategy("zero2"), mesh)
    events = []
    buckets = {b.shard_grad.data_ptr(): i for i, b in enumerate(opt.buckets)}
    names = {}
    for name, p in model.named_parameters():
        for i, b in enumerate(opt.buckets):
            if 0 <= p.data_ptr() - b.flat.data_ptr() < b.flat.numel() * b.flat.element_size():
                names[i] = tstrat.zero2_bucket(name)
    def on_output(i, out):
        out.register_hook(lambda g: events.append(("bwd", i)))

    for i, block in enumerate(model.blocks):
        block.register_forward_hook(lambda mod, inp, out, i=i: on_output(i, out))
    launch = torch.distributed.reduce_scatter_tensor

    def recording(output, input, *args, **kwargs):
        events.append(("rs", names[buckets[output.data_ptr()]],
                       torch._C._current_graph_task_id() != -1))
        return launch(output, input, *args, **kwargs)

    torch.distributed.reduce_scatter_tensor = recording
    try:
        TrainStep(model, opt, grad_accum=ACCUM, micro_batch=MICRO, seed=0, device=CPU,
                  mesh=mesh)(table, 0)
    finally:
        torch.distributed.reduce_scatter_tensor = launch
    return events


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
            "leaf_names": [name for name, _ in getattr(model, "module", model).named_parameters()],
        }
        if remat is None or remat == "none":
            row = run_benchmark(strategy=arm, tier="S", seq_len=S, steps=3, warmup_steps=1,
                                per_device_batch=MICRO, grad_accum=ACCUM, device="cpu",
                                world_size=world)
            res["rows"][arm] = row.to_dict()
    if world == 2:
        res["losses"]["zero2_single"] = zero2_forms(params, table, arrays, rank)
        res["zero2_events"] = zero2_launch_order(params, table)
        for arm in OFFLOAD_ARMS:
            label = f"{arm}_offload"
            strat = _strategy(arm, "none", offload_opt_state=True)
            mesh = make_mesh()
            model = TinyGPT(offload_config(), mesh=mesh)
            bridge.load_jax_params(model, params)
            model, opt = tstrat.apply_strategy(model, strat, mesh)
            step_fn = TrainStep(model, opt, grad_accum=ACCUM, micro_batch=MICRO, seed=0,
                                device=CPU, mesh=mesh)
            res["losses"][label] = [step_fn(table, step).item() for step in range(STEPS)]
            got = master_tree(model, opt, mesh)
            if rank == 0:
                arrays.update({f"{label}.{k}": v for k, v in got.items() if k != "blocks"})
                arrays.update({f"{label}.blocks.{k}": v for k, v in got["blocks"].items()})
        row = run_benchmark(strategy=dataclasses.replace(tstrat.get_strategy("zero2"),
                                                         offload_opt_state=True),
                            tier="S", seq_len=S, steps=3, warmup_steps=1, per_device_batch=MICRO,
                            grad_accum=ACCUM, device="cpu", world_size=world)
        res["rows"]["zero2_offload"] = row.to_dict()
    np.savez(f"{out}.rank{rank}.npz", **arrays)
    return res


def offload_config():
    """The offload runs' model: the parity runs' at bf16 parameters."""
    return get_config("tinygpt", "S", S, dropout=0.0, compute_dtype=torch.float32,
                      attention_impl="flash", param_dtype=torch.bfloat16)


def held():
    res = {}
    for family in ("tinygpt", "llama"):
        for (suffix, change), arm in ((kind, arm) for kind in STATE_KINDS.items()
                                      for arm in sorted(tstrat.STRATEGIES)):
            strat = _strategy(arm, "none", **change)
            cfg = get_config(family, "S", S, compute_dtype=torch.float32, attention_impl="flash",
                             dropout=0.0, param_dtype=tstrat.param_torch_dtype(strat))
            mesh = make_mesh()
            model = TinyGPT(cfg, mesh=mesh)
            model.init_weights(torch.Generator().manual_seed(0))
            est = memory.estimate_hbm(cfg, strat, mesh, MICRO, S)
            model, opt = tstrat.apply_strategy(model, strat, mesh)
            table = torch.randint(0, cfg.vocab_size, (8, S),
                                  generator=torch.Generator().manual_seed(1))
            TrainStep(model, opt, grad_accum=ACCUM, micro_batch=MICRO, seed=0, device=CPU,
                      mesh=mesh)(table, 0)
            res[f"{family}.{arm}{suffix}"] = {"held": list(held_bytes(model, opt)),
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
