"""One rank of the numerics-sentinel checks over gloo on the CPU: the helper
of ``tests/test_torch_sentinel.py``, which holds no test itself and imports
torch and the port only.

    python tests/torch_sentinel_worker.py RANK WORLD PORT INPUTS OUT

``INPUTS`` is an .npz of the JAX params (``wte``, ``blocks.wqkv``, ...) and
the batch table (``table``). For each arm of ``ARMS``: tier S TinyGPT at
S 64, fp32 compute, flash, dropout 0, loaded from the JAX params, laid out
by ``apply_strategy`` over (data WORLD), and one ``TrainStep`` with the
sentinel armed (per-device batch 1 x accum 2): the parameter checksum
before and after the step and the step's grad norm; then, on a fresh copy
of the arm, ``bitflip@0`` and ``grad-explode@0`` through the injector, each
followed by the gathered params (rank 0) and whether this rank wrote the
flipped element. Then ``run_benchmark`` of each arm of ``HEAL_ARMS`` with
the sentinel, a checkpoint every 2 steps and ``bitflip@5``: the row and
this rank's ``sentinel_trip`` / ``rollback`` events. Writes
``OUT.rank<RANK>.npz`` and ``OUT.rank<RANK>.json``.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.faults import (
    FaultInjector,
    parse_fault_spec,
)
from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT, get_config
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import make_mesh
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.runtime import distributed as rt
from distributed_llm_training_benchmark_framework_tpu_torch.telemetry.recorder import (
    read_events,
    telemetry_filename,
)
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark
from distributed_llm_training_benchmark_framework_tpu_torch.train.step import TrainStep

S, MICRO, ACCUM = 64, 1, 2
ARMS = ("ddp", "fsdp", "zero2")
HEAL_ARMS = ("zero2", "fsdp")
HEAL_STEPS, HEAL_EVERY, HEAL_FAULT = 8, 2, "bitflip@5"
CPU = torch.device("cpu")


def _strategy(arm):
    return dataclasses.replace(tstrat.get_strategy(arm), precision="f32")


def _tree(data):
    params = {"blocks": {}}
    for key in data.files:
        if key.startswith("blocks."):
            params["blocks"][key.split(".", 1)[1]] = data[key]
        elif key != "table":
            params[key] = data[key]
    return params


def _arm(arm, params):
    mesh = make_mesh()
    model = TinyGPT(get_config("tinygpt", "S", S, dropout=0.0, compute_dtype=torch.float32,
                               attention_impl="flash"), mesh=mesh)
    bridge.load_jax_params(model, params)
    return tstrat.apply_strategy(model, _strategy(arm), mesh), mesh


def _flat(tree, prefix):
    out = {f"{prefix}.{k}": v for k, v in tree.items() if k != "blocks"}
    out.update({f"{prefix}.blocks.{k}": v for k, v in tree["blocks"].items()})
    return out


def norms_and_hooks(rank, data, arrays):
    params, table = _tree(data), torch.from_numpy(data["table"].astype(np.int64))
    res = {}
    for arm in ARMS:
        (model, opt), mesh = _arm(arm, params)
        step_fn = TrainStep(model, opt, grad_accum=ACCUM, micro_batch=MICRO, seed=0, device=CPU,
                            mesh=mesh, sentinel=True)
        before = float(step_fn.param_checksum())
        loss = float(step_fn(table, 0))
        res[arm] = {"checksum_before": before, "loss": loss,
                    "grad_norm": float(step_fn.optimizer.grad_norm),
                    "checksum_after": float(step_fn.param_checksum())}
        for kind in ("bitflip", "grad-explode"):
            (model, _opt), _mesh = _arm(arm, params)
            inner = getattr(model, "module", model)
            before = {n: p.detach().clone() for n, p in inner.named_parameters()}
            FaultInjector(parse_fault_spec(f"{kind}@0"), is_main=False,
                          rank=rank).corrupt_params(0, inner)
            res[arm][f"{kind}_changed_here"] = sum(
                int((_local(p) != _local(before[n])).sum()) for n, p in inner.named_parameters())
            got = bridge.export_params(model)
            if rank == 0:
                arrays.update(_flat(got, f"{arm}.{kind}"))
    return res


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def heal(rank, out):
    res = {}
    for arm in HEAL_ARMS:
        results = os.path.join(out, f"heal_{arm}")
        row = run_benchmark(strategy=_strategy(arm), tier="S", seq_len=S, warmup_steps=1,
                            device="cpu", sync_every=2, dropout=0.1, grad_accum=ACCUM,
                            per_device_batch=MICRO, steps=HEAL_STEPS, sentinel=True,
                            checkpoint_dir=os.path.join(out, f"ck_{arm}"),
                            checkpoint_every=HEAL_EVERY, inject_fault=HEAL_FAULT,
                            results_dir=results, heartbeat_sec=0)
        arm_slug = f"{arm}_ws2_seq{S}_tierS"
        events = read_events(os.path.join(results, telemetry_filename(arm_slug, rank)))
        res[arm] = {"row": row.to_dict(),
                    "events": [e for e in events if e["event"] in ("sentinel_trip", "rollback")]}
    return res


def main():
    rank, world, port, inputs, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    assert rt.setup_distributed(num_processes=world, process_id=rank, master_port=int(port),
                                device="cpu")
    arrays = {}
    try:
        res = {"norms": norms_and_hooks(rank, np.load(inputs), arrays),
               "heal": heal(rank, os.path.dirname(out))}
    finally:
        rt.barrier()
        rt.cleanup_distributed()
    np.savez(f"{out}.rank{rank}.npz", **arrays)
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
