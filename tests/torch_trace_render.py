"""Render step-anatomy traces in ``torch.profiler``'s Chrome dialect.

The port's step anatomy reads kineto exports, and JAX's frozen fixtures
(``tests/fixtures/trace_frozen*/``) are XLA traces. This helper renders a
device timeline, (step name, t0, t1) steps and (op name, t0, t1) ops on the
unix-epoch microsecond clock, as a kineto export lays it out:

- ``ts`` relative to the export's ``baseTimeNanoseconds``;
- a host process (labelled "CPU") with one ``ProfilerStep#N``
  ``user_annotation`` per step: the host leads the card, so step N's span
  opens ``HOST_LEAD_US`` before its first device op and closes where step
  N+1's opens (``profile.step``), and the last one closes at the step's end
  (the loop fences before it stops the trace);
- inside each span, one ``cpu_op`` and one ``cudaLaunchKernel``
  (``cuda_runtime``) per device op, joined to the op by ``External id`` and
  ``correlation``;
- a GPU process labelled "GPU 0" whose threads are streams: compute
  kernels on stream 7, NCCL kernels on stream 20 (they overlap compute);
- XLA op names mapped to CUDA kernel names: a collective to the NCCL kernel
  of its class (JAX's send and recv both to NCCL's one point-to-point
  kernel, ``ncclDevKernel_SendRecv``), anything else to an elementwise
  kernel.

``render_dir`` writes a JAX fixture directory's traces this way into a new
directory (rank 0 as ``tensorboard_trace_handler`` names a file, plain
JSON; rank siblings as ``<stem>.rank<r>.trace.json.gz``) beside its
telemetry JSONL and, when asked, a cost JSON scaled to the H100's peaks.
The JAX fixtures themselves are read, never written.
"""

import gzip
import json
import os
import re

from distributed_llm_training_benchmark_framework_tpu.analysis import (
    profile_summary as jps,
    step_anatomy as jsa,
)

BASE_NS = 1_754_100_000_000_000_000  # a whole second: base_us is an integer
BASE_US = BASE_NS // 1000
HOST_PID = 4242
GPU_PID, COMPUTE_STREAM, NCCL_STREAM = 0, 7, 20
HOST_LEAD_US = 400
H100 = "NVIDIA H100 80GB HBM3"

NCCL_KERNELS = {
    "all-reduce": "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
    "all-gather": "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
    "reduce-scatter":
        "ncclDevKernel_ReduceScatter_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
    "collective-broadcast": "ncclDevKernel_Broadcast_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
    "send": "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
    "recv": "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
}
COMPUTE_KERNEL = ("void at::native::vectorized_elementwise_kernel<4, "
                  "at::native::CUDAFunctor_add<float>>(int, {0})")


def kernel_name(xla_name: str) -> str:
    """The CUDA kernel that stands for an XLA op."""
    if jsa.is_collective_op(xla_name):
        return NCCL_KERNELS[jps.op_class(xla_name)]
    return COMPUTE_KERNEL.format(xla_name)


def jax_timeline(trace_path: str):
    """(steps, ops) of the first device of a JAX trace, on its own clock."""
    devs = jsa.device_timelines(jps.load_events(trace_path))
    dev = devs[sorted(devs)[0]]
    return sorted(dev["steps"], key=lambda s: s[1]), dev["ops"]


def _x(cat, name, pid, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts - BASE_US, "dur": dur, "args": args}


def _meta(kind, pid, tid, **args):
    return {"ph": "M", "name": kind, "pid": pid, "tid": tid, "ts": 0, "args": args}


def render(steps, ops, host_noise=()) -> dict:
    """A kineto-style export of one device's (steps, ops) (module docstring);
    ``host_noise`` adds (name, t0, t1) host ``cpu_op`` spans."""
    events = [
        _meta("process_name", HOST_PID, 0, name="python3"),
        _meta("process_labels", HOST_PID, 0, labels="CPU"),
        _meta("thread_name", HOST_PID, HOST_PID, name=f"thread {HOST_PID} (python3)"),
        _meta("process_name", GPU_PID, 0, name="python3"),
        _meta("process_labels", GPU_PID, 0, labels="GPU 0"),
        _meta("thread_name", GPU_PID, COMPUTE_STREAM, name=f"stream {COMPUTE_STREAM} "),
        _meta("thread_name", GPU_PID, NCCL_STREAM, name=f"stream {NCCL_STREAM} "),
    ]
    steps = sorted(steps, key=lambda s: s[1])
    spans = []
    for i, (name, t0, t1) in enumerate(steps):
        h0 = t0 - HOST_LEAD_US
        h1 = steps[i + 1][1] - HOST_LEAD_US if i + 1 < len(steps) else t1
        spans.append((h0, h1))
        events.append(_x("user_annotation", f"ProfilerStep#{name}", HOST_PID, HOST_PID, h0,
                         h1 - h0, **{"External id": 0}))
    corr = 0
    launched_in = [0] * len(steps)
    for name, a, b in sorted(ops, key=lambda o: o[1]):
        k = next(i for i, (_, t0, t1) in enumerate(steps) if t0 <= a < t1)
        corr += 1
        t_launch = spans[k][0] + 10 + launched_in[k]
        launched_in[k] += 1
        kname = kernel_name(name)
        events.append(_x("cpu_op", f"aten::{re.sub(r'[.-]', '_', name)}", HOST_PID, HOST_PID,
                         t_launch - 1, 3, **{"External id": corr}))
        events.append(_x("cuda_runtime", "cudaLaunchKernel", HOST_PID, HOST_PID, t_launch, 1,
                         **{"External id": corr, "correlation": corr}))
        stream = NCCL_STREAM if kname.startswith("nccl") else COMPUTE_STREAM
        events.append(_x("kernel", kname, GPU_PID, stream, a, b - a,
                         **{"External id": corr, "correlation": corr, "device": 0,
                            "stream": stream}))
    for name, t0, t1 in host_noise:
        events.append(_x("cpu_op", name, HOST_PID, HOST_PID, t0, t1 - t0))
    return {"schemaVersion": 1, "deviceProperties": [], "displayTimeUnit": "ms",
            "baseTimeNanoseconds": BASE_NS, "traceEvents": events}


def write_trace(path: str, trace: dict) -> str:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump(trace, f)
    return path


def h100_cost(jax_cost: dict) -> dict:
    """JAX's frozen cost JSON (tuned to 25% / 50% of TPU v5e's peaks at its
    median step) scaled to the H100's: the same shares of 989 TFLOP/s and
    3,350 GB/s."""
    return {"flops": jax_cost["flops"] * 989.0 / 197.0,
            "bytes_accessed": jax_cost["bytes_accessed"] * 3350.0 / 819.0,
            "device_kind": H100, "world_size": jax_cost["world_size"],
            "scope": "model_flops"}


def render_dir(jax_dir: str, out_dir: str, with_cost: bool = True,
               meta_over: dict = None) -> str:
    """``jax_dir``'s traces, telemetry and (scaled) cost in torch's dialect
    under ``out_dir``; ``meta_over`` updates the telemetry's ``run_meta``."""
    os.makedirs(out_dir, exist_ok=True)
    for f in sorted(os.listdir(jax_dir)):
        src = os.path.join(jax_dir, f)
        if f.endswith(".trace.json.gz"):
            steps, ops = jax_timeline(src)
            events = jps.load_events(src)
            pids, _ = jps._lane_names(events)
            noise = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("ph") == "X" and not pids.get(e["pid"], "").startswith("/device:")]
            m = jsa._RANK_TRACE_RE.search(f)
            name = (f"{f[:m.start()]}.rank{m.group(1)}.trace.json.gz" if m
                    else f"host_{HOST_PID}.1754200000000.pt.trace.json")
            write_trace(os.path.join(out_dir, name), render(steps, ops, noise))
        elif f.endswith(".jsonl"):
            lines = open(src).read().splitlines()
            if meta_over:
                meta = json.loads(lines[0])
                meta.update(meta_over)
                lines[0] = json.dumps(meta)
            with open(os.path.join(out_dir, f), "w") as out:
                out.write("\n".join(lines) + "\n")
        elif f == jsa.COST_JSON_FILENAME and with_cost:
            with open(src) as fin, open(os.path.join(out_dir, f), "w") as out:
                json.dump(h100_cost(json.load(fin)), out)
    return out_dir
