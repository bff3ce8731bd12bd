"""The distributed runtime (``runtime/distributed.py``): the launcher's
environment, the process group, the barrier and the flags between ranks,
over three gloo ranks on localhost (children import torch and the port
only)."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

from distributed_llm_training_benchmark_framework_tpu_torch.runtime import distributed as rt

REPO = Path(__file__).resolve().parents[1]

_WORKER = """
import json, sys, time
from distributed_llm_training_benchmark_framework_tpu_torch.runtime import distributed as rt

rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
res = {"made": rt.setup_distributed(num_processes=3, process_id=rank, master_port=port,
                                    device="cpu")}
res["world"], res["rank"], res["main"] = rt.get_world_size(), rt.get_rank(), rt.is_main_process()
res["flags_before"] = rt.preempt_flag_entries()
t0 = time.monotonic()
if rank == 1:
    time.sleep(0.5)
rt.barrier()
res["barrier_wait"] = time.monotonic() - t0
if rank == 1:
    res["published"] = [rt.publish_preempt_flag(7), rt.publish_hang_flag(9)]
rt.barrier()
res["preempt"], res["hang"] = rt.preempt_flag_entries(), rt.hang_flag_entries()
# Rank 2 never acks this round: ranks 0 and 1 give up within the deadline.
if rank != 2:
    t0 = time.monotonic()
    res["lonely"] = rt.agree_preempt_step(10 + rank, timeout_sec=1.0)
    res["lonely_wait"] = time.monotonic() - t0
rt.barrier()
res["agreed"] = rt.agree_preempt_step(10 + rank, timeout_sec=30.0)
rt.barrier()
# A later run in the same group reads only its own flags.
rt.begin_run()
res["next_run"] = [rt.preempt_flag_entries(), rt.hang_flag_entries()]
rt.barrier()
rt.cleanup_distributed()
res["after"] = [rt.get_world_size(), rt.publish_preempt_flag(3), rt.agree_preempt_step(5)]
json.dump(res, open(f"{out}.{rank}.json", "w"))
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("rt") / "r"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(port), str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(3)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-3000:]
    return [json.loads(Path(f"{out}.{r}.json").read_text()) for r in range(3)]


def test_group_and_barrier(ranks):
    for r, res in enumerate(ranks):
        assert res["made"] and (res["world"], res["rank"], res["main"]) == (3, r, r == 0)
        assert res["barrier_wait"] >= 0.4  # everyone waited for rank 1
        assert res["flags_before"] == []
        assert res["after"] == [1, False, 5]  # torn down: no group, no store


def test_flags_published_by_one_rank_reach_every_rank(ranks):
    assert ranks[1]["published"] == [True, True]
    for res in ranks:
        assert res["preempt"] == [[1, 7]] and res["hang"] == [[1, 9]]


def test_agree_preempt_step(ranks):
    for res in ranks[:2]:
        assert res["lonely"] is None and 0.9 <= res["lonely_wait"] < 10
    assert [res["agreed"] for res in ranks] == [12, 12, 12]


def test_a_later_run_starts_with_no_flags(ranks):
    assert [res["next_run"] for res in ranks] == [[[], []]] * 3


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "0", "MASTER_ADDR": "10.0.0.1",
      "MASTER_PORT": "1234"}, rt.DistEnv(4, 2, 0, "10.0.0.1", 1234)),
    ({"WORLD_SIZE": "1"}, rt.DistEnv(1, 0, 0, "127.0.0.1", 29500)),
    ({"NUM_PROCESSES": "2", "PROCESS_ID": "1", "COORDINATOR_ADDRESS": "host:4321"},
     rt.DistEnv(2, 1, 1, "host", 4321)),
    ({"NUM_PROCESSES": "8", "TPU_WORKER_ID": "5"}, rt.DistEnv(8, 5, 5, "127.0.0.1", 29500)),
    ({"NUM_PROCESSES": "3", "JOB_COMPLETION_INDEX": "2", "MASTER_ADDR": "a"},
     rt.DistEnv(3, 2, 2, "a", 29500)),
    # The JAX contract's order: PROCESS_ID before RANK, and the coordinator
    # before MASTER_ADDR; torchrun's RANK and MASTER_* when WORLD_SIZE is set.
    ({"NUM_PROCESSES": "2", "PROCESS_ID": "1", "RANK": "0", "MASTER_ADDR": "m",
      "COORDINATOR_ADDRESS": "c:7"}, rt.DistEnv(2, 1, 1, "c", 7)),
    ({"WORLD_SIZE": "2", "PROCESS_ID": "0", "RANK": "1", "COORDINATOR_ADDRESS": "c:7"},
     rt.DistEnv(2, 1, 1, "127.0.0.1", 29500)),
])
def test_env_contract(env, want):
    assert rt.read_env(env) == want


def test_arguments_win_and_bad_geometry_is_refused():
    env = {"WORLD_SIZE": "4", "RANK": "3", "MASTER_PORT": "1"}
    assert rt.read_env(env, num_processes=2, process_id=1, master_port=7, master_addr="h") == (
        rt.DistEnv(2, 1, 1, "h", 7))
    with pytest.raises(ValueError, match="outside world size"):
        rt.read_env({"WORLD_SIZE": "2", "RANK": "2"})
    with pytest.raises(ValueError, match=">= 1"):
        rt.read_env({"WORLD_SIZE": "0"})


def test_no_group_at_world_one_without_a_launcher(monkeypatch):
    for var in ("WORLD_SIZE", "NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    assert rt.setup_distributed(device="cpu") is False
    assert not dist.is_initialized() and rt.get_world_size() == 1
    assert rt.preempt_flag_entries() == [] and rt.agree_preempt_step(4) == 4
    rt.barrier()  # a no-op without a group
