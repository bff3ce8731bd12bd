"""One rank of the tensor-parallel checks over gloo on the CPU: the helper
of ``tests/test_torch_tp.py``, ``tests/test_torch_tp_seq.py`` and
``tests/test_torch_tp_cmm.py``, which holds no test itself and imports torch
and the port only.

    python tests/torch_tp_worker.py RANK WORLD PORT INPUTS OUT MODE

``INPUTS`` holds each family's JAX params (``tinygpt.wte``,
``llama.blocks.wq``, ...; ``llama4`` is the llama family at 4 query / 2 kv
heads, whose kv heads a ``model`` width of 2 splits) and the batch table.
Every run is tier S at S 64, fp32 compute, dropout 0, per-device batch 1 x
accum 2, loaded from the JAX params (each rank keeps its shards), trained 3
steps by ``TrainStep``. ``MODE``:

- ``train``: the ranks are laid out (data WORLD/2, model 2); each family and
  arm of ``ARMS[WORLD]``: every step's loss, the final params gathered back
  to JAX's leaves (rank 0), the local shapes of every leaf, and, after one
  more micro-batch's gradient, the clip's global norm (``Optimizer``)
  beside the norm of the whole gradient gathered over ``data`` and
  ``model``. Then the params of a fresh load, laid out by
  fsdp and gathered back (the round trip). At WORLD 2 also
  ``run_benchmark`` at dropout 0.1, per-device batch 2, tp 2 (fp32; seeded
  weights): every step's loss and the row; TinyGPT under zero2 with the
  serial host-offload arm (bf16 parameters, the JAX params rounded to
  bf16): every step's loss and the fp32 masters gathered to JAX's leaves
  (rank 0); and the refusal of a ``model`` width of 3, which the world does
  not divide.
- ``seq``: (data 1, seq 2, model 2) at WORLD 4; ring and Ulysses for
  ``SEQ_FAMILIES``, zero2: every step's loss and the final params; then
  ``run_benchmark`` with the ring at dropout 0.1, per-device batch 2
  (seeded weights): every step's loss; then ``ulysses_attention_sharded``
  and ``ring_attention_sharded`` at dropout 0.1 on this rank's columns and
  heads of ``INPUTS``' (B, S, H, Dh) ``q``, ``k``, ``v``, ``do``: the output
  and the gradients of ``sum(out * do)``.
- ``cmm``: (model 2) at WORLD 2; for each family the loss and gradients of
  one forward and backward on ``cmm_batch`` with and without
  ``tp_collective_matmul`` (gradients gathered to JAX's leaves), zero2
  trained 3 steps both ways, and ``ag_proj`` / ``rs_proj`` (global forms)
  on ``INPUTS``' ``x``, ``w1``, ``y``, ``w2``, ``wkv`` with the gradients
  of the sums of their outputs. Then TinyGPT at dropout 0.1 under remat
  none, dots and full, with and without the collective matmul: the loss
  and gradients of one forward and backward (same seeds and generator).

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
import torch.distributed as dist

from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT, get_config
from distributed_llm_training_benchmark_framework_tpu_torch.ops import collective_matmul as tcm
from distributed_llm_training_benchmark_framework_tpu_torch.ops import ring_attention as tra
from distributed_llm_training_benchmark_framework_tpu_torch.ops import ulysses_attention as tua
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import make_mesh
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.runtime import distributed as rt
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark
from distributed_llm_training_benchmark_framework_tpu_torch.train.step import TrainStep

from test_torch_arms_worker import master_tree

S, MICRO, ACCUM, STEPS, TP = 64, 1, 2, 3, 2
ATTENTION_SEED = 1234
FAMILIES = ("tinygpt", "llama", "llama4")
SEQ_FAMILIES = ("tinygpt", "llama4")
IMPLS = ("ring", "ulysses")
# The arms each world trains: every arm over (data 2, model 2); zero2, the
# bench's arm, over (model 2).
ARMS = {4: ("ddp", "fsdp", "zero2", "zero3"), 2: ("zero2",)}
# The llama family with kv heads that a model width of 2 splits (tier S has
# 2 query / 1 kv heads, which it does not).
OVERRIDES = {"tinygpt": ("tinygpt", {}), "llama": ("llama", {}),
             "llama4": ("llama", {"n_head": 4, "n_kv_head": 2})}
CPU = torch.device("cpu")
F32_ZERO2 = dataclasses.replace(tstrat.get_strategy("zero2"), precision="f32")
REPO = Path(__file__).resolve().parents[1]


def config(family, **kw):
    fam, over = OVERRIDES[family]
    return get_config(fam, "S", S, **{"dropout": 0.0, "compute_dtype": torch.float32,
                                      **over, **kw})


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


def tree(data, family):
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


def flat(label, params):
    """{label.leaf: array} of a JAX-shaped tree, for an npz."""
    out = {f"{label}.{k}": v for k, v in params.items() if k != "blocks"}
    out.update({f"{label}.blocks.{k}": v for k, v in params["blocks"].items()})
    return out


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _train(family, arm, mesh, data, table, impl="flash", cmm=False):
    strat = dataclasses.replace(tstrat.get_strategy(arm), precision="f32", remat="none")
    model = TinyGPT(config(family, attention_impl=impl, tp_collective_matmul=cmm), mesh=mesh)
    bridge.load_jax_params(model, tree(data, family))
    model, opt = tstrat.apply_strategy(model, strat, mesh)
    step_fn = TrainStep(model, opt, grad_accum=ACCUM, micro_batch=MICRO, seed=0, device=CPU,
                        mesh=mesh)
    losses = [step_fn(table, step).item() for step in range(STEPS)]
    return model, opt, losses


def _norms(model, opt, mesh, arm, table):
    """(the clip's norm, the whole gradient's) after one micro-batch."""
    d, dp = mesh.data_rank, mesh.size("data")
    opt.zero_grad()
    with opt.sync_context(last=True):
        micro = table[:dp]
        _, loss = model(micro[d:d + 1], micro[d:d + 1], batch_offset=d, global_batch=dp)
        loss.backward()
    opt.finish_grads(1)
    got = opt._global_norm_sharded().item()
    inner = getattr(model, "module", model)
    sq = torch.zeros((), dtype=torch.float64)
    _, t = inner.tp
    for name, p in inner.named_parameters():
        g = p.grad.full_tensor() if hasattr(p.grad, "full_tensor") else p.grad.clone()
        if arm == "zero2":  # the flat buffers hold this rank's unreduced sums
            dist.all_reduce(g, group=mesh.data_group)
            g /= dp
        if tstrat.tp_axis(name, inner.config.kv_heads, t) is not None:
            parts = [torch.empty_like(g) for _ in range(t)]
            dist.all_gather(parts, g.contiguous(), group=mesh.model_group)
            g = torch.cat(parts)
        sq += g.double().square().sum()
    return got, sq.sqrt().item()


def train(rank, world, data, out):
    table = torch.from_numpy(data["table"].astype(np.int64))
    mesh = make_mesh((TP,), ("model",))
    res = {"mesh": [mesh.size("data"), mesh.data_rank, mesh.model_rank, mesh.world],
           "losses": {}, "shapes": {}, "norms": {}}
    arrays = {}
    for family in FAMILIES:
        for arm in ARMS[world]:
            label = f"{family}.{arm}"
            model, opt, res["losses"][label] = _train(family, arm, mesh, data, table)
            got = bridge.export_params(model)
            if rank == 0:
                arrays.update(flat(label, got))
            inner = getattr(model, "module", model)
            res["shapes"][label] = {n: list(_local(p).shape) for n, p in inner.named_parameters()}
            res["norms"][label] = _norms(model, opt, mesh, arm, table)
        model = TinyGPT(config(family), mesh=mesh)
        bridge.load_jax_params(model, tree(data, family))
        model, _ = tstrat.apply_strategy(model, tstrat.get_strategy("fsdp"), mesh)
        if rank == 0:
            arrays.update(flat(f"{family}.roundtrip", bridge.export_params(model)))
        else:
            bridge.export_params(model)
    if world == 2:
        losses = []
        row = run_benchmark(strategy=F32_ZERO2, tier="S", seq_len=S, steps=STEPS,
                            warmup_steps=1, per_device_batch=2, grad_accum=ACCUM, dropout=0.1,
                            device="cpu", world_size=world, tensor_parallel=TP,
                            loss_log=losses)
        res["row"], res["dropout_losses"] = row.to_dict(), losses
        strat = dataclasses.replace(F32_ZERO2, offload_opt_state=True)
        model = TinyGPT(config("tinygpt", param_dtype=torch.bfloat16), mesh=mesh)
        bridge.load_jax_params(model, tree(data, "tinygpt"))
        model, opt = tstrat.apply_strategy(model, strat, mesh)
        step_fn = TrainStep(model, opt, grad_accum=ACCUM, micro_batch=MICRO, seed=0,
                            device=CPU, mesh=mesh)
        res["offload_losses"] = [step_fn(table, step).item() for step in range(STEPS)]
        got = master_tree(model, opt, mesh)
        if rank == 0:
            arrays.update(flat("offload", got))
    try:
        make_mesh((3,), ("model",))
    except ValueError as e:
        res["refusal"] = str(e)
    np.savez(f"{out}.rank{rank}.npz", **arrays)
    return res


def seq(rank, world, data, out):
    table = torch.from_numpy(data["table"].astype(np.int64))
    mesh = make_mesh((2, TP), ("seq", "model"))
    res = {"mesh": [mesh.size("data"), mesh.seq_rank, mesh.model_rank, mesh.world],
           "losses": {}}
    arrays = {}
    for family in SEQ_FAMILIES:
        for impl in IMPLS:
            label = f"{family}.{impl}"
            model, _, res["losses"][label] = _train(family, "zero2", mesh, data, table, impl)
            got = bridge.export_params(model)
            if rank == 0:
                arrays.update(flat(label, got))
    res["dropout_losses"] = []
    run_benchmark(strategy=F32_ZERO2, tier="S", seq_len=S, steps=STEPS, warmup_steps=1,
                  per_device_batch=2, grad_accum=ACCUM, dropout=0.1, attention_impl="ring",
                  sequence_parallel=2, device="cpu", world_size=world, tensor_parallel=TP,
                  loss_log=res["dropout_losses"])
    q, k, v, do = (torch.from_numpy(data[x]) for x in ("q", "k", "v", "do"))
    s, m = mesh.seq_rank, mesh.model_rank
    Sl, Hl, H = q.shape[1] // 2, q.shape[2] // TP, q.shape[2]
    part = [t[:, s * Sl:(s + 1) * Sl, m * Hl:(m + 1) * Hl] for t in (q, k, v, do)]
    kw = dict(group=mesh.seq_group, dropout_rate=0.1, dropout_seed=ATTENTION_SEED)
    forms = {
        "ulysses": lambda a, b, c: tua.ulysses_attention_sharded(a, b, c, head_shard=(m, TP),
                                                                 **kw),
        "ring": lambda a, b, c: tra.ring_attention_sharded(a, b, c, head_offset=m * Hl,
                                                           n_heads=H, **kw),
    }
    for form, fn in forms.items():
        a, b, c = (t.clone().requires_grad_(True) for t in part[:3])
        o = fn(a, b, c)
        grads = torch.autograd.grad((o * part[3]).sum(), (a, b, c))
        for name, x in zip(("out", "dq", "dk", "dv"), (o.detach(), *grads)):
            arrays[f"att.{form}.{name}"] = x.numpy()
    np.savez(f"{out}.rank{rank}.npz", **arrays)
    return res


def _grads(model):
    """The gradients of ``model``'s leaves, gathered over ``model`` into
    JAX's leaves (as ``bridge.export_params`` gathers the params)."""
    saved = [p.data for p in model.parameters()]
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.grad
    out = bridge.export_params(model)
    with torch.no_grad():
        for p, d in zip(model.parameters(), saved):
            p.data = d
    return out


def cmm(rank, world, data, out):
    table = torch.from_numpy(data["table"].astype(np.int64))
    mesh = make_mesh((TP,), ("model",))
    group = mesh.model_group
    res = {"loss": {}, "losses": {}}
    arrays = {}
    batch = torch.from_numpy(data["cmm_batch"].astype(np.int64))
    for family in ("tinygpt", "llama"):
        for on in (False, True):
            label = f"{family}.{on}"
            model = TinyGPT(config(family, attention_impl="flash", tp_collective_matmul=on),
                            mesh=mesh)
            bridge.load_jax_params(model, tree(data, family))
            _, loss = model(batch, batch)
            loss.backward()
            res["loss"][label] = loss.item()
            grads = _grads(model)
            if rank == 0:
                arrays.update(flat(f"grad.{label}", grads))
            _, _, res["losses"][label] = _train(family, "zero2", mesh, data, table, cmm=on)
    tensors = {k: torch.from_numpy(data[k]).requires_grad_(True)
               for k in ("x", "w1", "y", "w2", "wkv")}
    forms = {
        "ag": lambda t: tcm.ag_proj(t["x"], t["w1"], group),
        "rs": lambda t: tcm.rs_proj(t["y"], t["w2"], group),
        "ag_kv": lambda t: tcm.ag_proj(t["x"], t["wkv"], group, aligned_units=1),
        "ag_plain": lambda t: tcm.ag_proj(t["x"], t["w1"], None),
    }
    for name, fn in forms.items():
        for t in tensors.values():
            t.grad = None
        y = fn(tensors)
        y.sum().backward()
        arrays[f"{name}.out"] = y.detach().numpy()
        for k, t in tensors.items():
            if t.grad is not None:
                arrays[f"{name}.d{k}"] = t.grad.numpy()
    res["remat"] = {}
    for on in (False, True):
        for remat in ("none", "dots", "full"):
            label = f"{on}.{remat}"
            cfg = config("tinygpt", attention_impl="flash", tp_collective_matmul=on,
                         dropout=0.1, remat=remat)
            model = TinyGPT(cfg, mesh=mesh)
            bridge.load_jax_params(model, tree(data, "tinygpt"))
            _, loss = model(batch, batch, attn_seeds=[7, 8],
                            generator=torch.Generator().manual_seed(3))
            loss.backward()
            res["remat"][label] = loss.item()
            arrays.update(flat(f"remat.{label}", _grads(model)))
    np.savez(f"{out}.rank{rank}.npz", **arrays)
    return res


def main():
    rank, world, port, inputs, out, mode = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    assert rt.setup_distributed(num_processes=world, process_id=rank, master_port=int(port),
                                device="cpu")
    try:
        res = {"train": train, "seq": seq, "cmm": cmm}[mode](rank, world, np.load(inputs), out)
    finally:
        dist.barrier()
        rt.cleanup_distributed()
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
