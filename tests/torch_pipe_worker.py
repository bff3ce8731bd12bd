"""One rank of the pipeline checks over gloo on the CPU: the helper of
``tests/test_torch_pipeline.py``, which holds no test itself and imports
torch and the port only.

    python tests/torch_pipe_worker.py RANK WORLD PORT INPUTS OUT MODE

``INPUTS`` holds the JAX params of the configurations of ``CONFIGS``
(``l2.wte``, ``moe.blocks.router``, ...) and the batch table. Every run is
tier S at S 64, fp32 compute, reference attention unless said otherwise,
per-device batch 1 x accum 4 (the schedule's M 4), loaded from the JAX
params (each stage keeps its layers), one step's gradient through
``TrainStep.accumulate`` or 3 steps through ``TrainStep``; gpipe and 1f1b
run the 2-layer model, interleaved the 4-layer one at V 2. ``MODE`` is a
geometry of ``GEOMETRIES``, (data, seq, pipe) widths whose product is
WORLD:

- ``pp2``: per schedule, the loss and (ddp) the gradient after the arm's
  reduction gathered to JAX's leaves, the messages each rank sent and the
  clip's norm under ddp and zero2, and how many of zero2's block buckets
  had started their reduce-scatter inside the schedule; the same
  gradients of the 4-expert MoE
  model; zero2 3 steps at dropout 0.1 under each schedule (the 4-layer
  model; losses); zero2 3 steps under 1f1b at bf16 parameters and under the
  serial and the delayed host-offload arm (losses, final params); ddp and zero2 3 steps
  under each schedule (losses, final params); a ``run_benchmark`` row
  under gpipe.
- ``dp2pp2``: every arm 3 steps under each schedule (losses, final
  params), the clip's norm under ddp, zero2 and fsdp under gpipe, and the
  gradient (ddp) and the messages under each schedule.
- ``sp2pp2``: the ring under each schedule and Ulysses under gpipe: the loss
  and the gradient (ddp); every arm 3 steps under 1f1b with the ring.

Writes ``OUT.rank<RANK>.npz`` (rank 0: the arrays, keys ``<label>.<leaf>``)
and ``OUT.rank<RANK>.json``.
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
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import make_mesh
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.parallel.pipeline import Pipeline
from distributed_llm_training_benchmark_framework_tpu_torch.runtime import distributed as rt
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark
from distributed_llm_training_benchmark_framework_tpu_torch.train.step import TrainStep

S, MICRO, ACCUM, STEPS, EXPERTS, V = 64, 1, 4, 3, 4, 2
# label -> (n_layer, experts)
CONFIGS = {"l2": (2, 0), "l4": (4, 0), "moe": (4, EXPERTS)}
# schedule -> the configuration it runs
SCHEDULE_CONFIG = {"gpipe": "l2", "1f1b": "l2", "interleaved": "l4"}
# mode -> (data, seq, pipe)
GEOMETRIES = {"pp2": (1, 1, 2), "dp2pp2": (2, 1, 2), "sp2pp2": (1, 2, 2)}
ARMS = ("ddp", "fsdp", "zero2", "zero3")
# mode -> the (arm, schedule) pairs trained 3 steps (under the ring at
# (seq 2, pipe 2))
TRAJECTORIES = {
    "pp2": [(arm, s) for arm in ("ddp", "zero2") for s in ("gpipe", "1f1b", "interleaved")],
    "dp2pp2": [(arm, s) for arm in ARMS for s in ("gpipe", "1f1b", "interleaved")],
    "sp2pp2": [(arm, "1f1b") for arm in ARMS],
}
NORM_ARMS = {"pp2": ("ddp", "zero2"), "dp2pp2": ("ddp", "zero2", "fsdp")}
# label -> the zero2 strategy change of the (pipe 2) 1f1b runs held to one
# process of the same dtype
OFFLOAD_RUNS = {"bf16": dict(param_dtype="bf16"), "offload": dict(offload_opt_state=True),
                "delayed": dict(offload_opt_state=True, offload_delayed_update=True)}
# (seq 2, pipe 2): (label, schedule, attention)
SEQ_RUNS = (("ring.gpipe", "gpipe", "ring"), ("ring.1f1b", "1f1b", "ring"),
            ("ring.interleaved", "interleaved", "ring"), ("ulysses.gpipe", "gpipe", "ulysses"))
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


def config(label, dropout=0.0, **kw):
    n_layer, experts = CONFIGS[label]
    return get_config("tinygpt", "S", S, n_layer=n_layer, dropout=dropout,
                      compute_dtype=torch.float32, attention_impl=kw.pop("attention", "reference"),
                      n_experts=experts, **kw)


def strategy(arm, **change):
    return dataclasses.replace(tstrat.get_strategy(arm), precision="f32", remat="none", **change)


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


def flat(label, params):
    out = {f"{label}.{k}": v for k, v in params.items() if k != "blocks"}
    out.update({f"{label}.blocks.{k}": v for k, v in params["blocks"].items()})
    return out


def laid_out(mesh, label, arm, schedule, params, dropout=0.0, attention="reference", **change):
    """(model as the arm returns it, its optimizer, the train step) of one
    stage, loaded from the JAX params."""
    strat = strategy(arm, **change)
    cfg = config(label, dropout, attention=attention,
                 param_dtype=tstrat.param_torch_dtype(strat))
    model = TinyGPT(cfg, mesh=mesh, virtual_stages=V if schedule == "interleaved" else 1)
    bridge.load_jax_params(model, params)
    model, opt = tstrat.apply_strategy(model, strat, mesh)
    pipe = Pipeline(schedule, mesh, ACCUM, CPU, V)
    step_fn = TrainStep(model, opt, grad_accum=ACCUM, micro_batch=MICRO, seed=0, device=CPU,
                        mesh=mesh, pipeline=pipe)
    return model, opt, step_fn


def mean_loss(step_fn, loss_sum):
    dist.all_reduce(loss_sum, group=step_fn.loss_group)
    return (loss_sum / (ACCUM * step_fn.stage_ranks)).item()


def gradient(mesh, label, arm, schedule, params, table, attention="reference", launched=None):
    """Step 0's gradient after the arm's reduction: (loss, the clip's norm,
    the messages this rank sent per direction, the gradient gathered to
    JAX's leaves or None where the arm keeps no whole gradient). Under
    zero2 ``launched`` gets [the block buckets whose reduce-scatter had
    started when the schedule ended, the block buckets]."""
    model, opt, step_fn = laid_out(mesh, label, arm, schedule, params, attention=attention)
    if launched is not None:
        finish = opt.finish_grads

        def counted(grad_accum):
            blocks = [b for b in opt.buckets if b.key]
            launched[:] = [sum(b.work is not None for b in blocks), len(blocks)]
            finish(grad_accum)

        opt.finish_grads = counted
    loss = mean_loss(step_fn, step_fn.accumulate(table, 0))
    norm = opt._clip_norm().item()
    sent = list(step_fn.pipeline.transport.sent)
    if arm != "ddp":
        return loss, norm, sent, None
    inner = model.module
    twin = TinyGPT(inner.config, mesh=mesh,
                   virtual_stages=V if schedule == "interleaved" else 1)
    with torch.no_grad():
        for t, p in zip(twin.parameters(), inner.parameters()):
            t.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    return loss, norm, sent, bridge.export_params(twin, pipe_group=mesh.pipe_group)


def trained(mesh, label, arm, schedule, params, table, dropout=0.0, attention="reference",
            **change):
    """``STEPS`` steps: (every step's loss, the final params)."""
    model, _, step_fn = laid_out(mesh, label, arm, schedule, params, dropout, attention,
                                 **change)
    losses = [step_fn(table, step).item() for step in range(STEPS)]
    return losses, bridge.export_params(model, pipe_group=mesh.pipe_group)


def main():
    rank, world, port, inputs, out, mode = sys.argv[1:7]
    rank, world = int(rank), int(world)
    dp, sp, pp = GEOMETRIES[mode]
    assert dp * sp * pp == world
    torch.set_num_threads(1)
    assert rt.setup_distributed(num_processes=world, process_id=rank, master_port=int(port),
                                device="cpu")
    data = np.load(inputs)
    table = torch.from_numpy(data["table"].astype(np.int64))
    params = {label: tree(data, label) for label in CONFIGS}
    res = {"losses": {}, "norms": {}, "sent": {}, "stage": None, "zero2_launched": {}}
    arrays = {}

    def keep(label, tree_):
        if rank == 0:  # bf16 leaves as fp32 (npz has no bf16), every value exact
            arrays.update({k: np.asarray(v, np.float32) for k, v in flat(label, tree_).items()})

    try:
        axes = [("seq", sp), ("pipe", pp)] if sp > 1 else [("pipe", pp)]
        mesh = make_mesh(tuple(w for _, w in axes), tuple(a for a, _ in axes))
        res["stage"] = list(mesh.pipe_shard)
        if mode == "sp2pp2":
            for label, schedule, attention in SEQ_RUNS:
                c = SCHEDULE_CONFIG[schedule]
                loss, _, sent, grads = gradient(mesh, c, "ddp", schedule, params[c], table,
                                                attention)
                res["losses"][label], res["sent"][label] = loss, sent
                keep(f"grad.{label}", grads)
            for arm, schedule in TRAJECTORIES[mode]:
                c = SCHEDULE_CONFIG[schedule]
                losses, final = trained(mesh, c, arm, schedule, params[c], table,
                                        attention="ring")
                res["losses"][f"{arm}.{schedule}"] = losses
                keep(f"{arm}.{schedule}", final)
        else:
            for schedule, c in SCHEDULE_CONFIG.items():
                arms = NORM_ARMS[mode] if mode == "pp2" or schedule == "gpipe" else ("ddp",)
                for arm in arms:
                    launched = [] if arm == "zero2" else None
                    loss, norm, sent, grads = gradient(mesh, c, arm, schedule, params[c], table,
                                                       launched=launched)
                    res["norms"][f"{arm}.{schedule}"] = norm
                    if launched is not None:
                        res["zero2_launched"][schedule] = launched
                    if grads is not None:
                        res["losses"][f"grad.{schedule}"] = loss
                        res["sent"][schedule] = sent
                        keep(f"grad.{schedule}", grads)
            for arm, schedule in TRAJECTORIES[mode]:
                c = SCHEDULE_CONFIG[schedule]
                losses, final = trained(mesh, c, arm, schedule, params[c], table)
                res["losses"][f"{arm}.{schedule}"] = losses
                keep(f"{arm}.{schedule}", final)
        if mode == "pp2":
            for schedule in ("gpipe", "1f1b", "interleaved"):
                loss, _, _, grads = gradient(mesh, "moe", "ddp", schedule, params["moe"], table)
                res["losses"][f"moe.{schedule}"] = loss
                keep(f"grad.moe.{schedule}", grads)
                res["losses"][f"dropout.{schedule}"], _ = trained(
                    mesh, "l4", "zero2", schedule, params["l4"], table, dropout=0.1)
            for label, change in OFFLOAD_RUNS.items():
                losses, final = trained(mesh, "l2", "zero2", "1f1b", params["l2"], table,
                                        **change)
                res["losses"][label] = losses
                keep(label, final)
            res["row"] = run_benchmark(strategy="zero2", tier="S", seq_len=S, steps=3,
                                       warmup_steps=1, per_device_batch=MICRO, grad_accum=ACCUM,
                                       device="cpu", world_size=world, pipeline_parallel=pp,
                                       pipeline_schedule="gpipe").to_dict()
    finally:
        rt.cleanup_distributed()
    np.savez(f"{out}.rank{rank}.npz", **arrays)
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
