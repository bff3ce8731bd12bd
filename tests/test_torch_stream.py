"""The port's streaming input path against the JAX package's, on the CPU.

- ``data/stream.py``: the shard writer and ``data/make_shards.py`` write
  JAX's bytes; over ``tests/fixtures/shards/`` both streams give the same
  batches, cursors, ``state_dict``, quarantine ledgers and errors, bit for
  bit, plainly and under each data hook (a corrupt record, a slow reader, a
  missing shard), across the epoch wrap;
- ``data/prefetch.py``: the prefetcher delivers JAX's batches in order with
  the same cursor snapshots (and one rank's rows and columns of them), and
  surfaces a producer error and a stall;
- end to end at tier S: a stream run's row (``data_mode`` "stream", the
  cursor pair, ``data_stall_frac``), a rollback plus replay equal to the
  straight run bit for bit in fp32, ``data-corrupt-record`` healed with
  ``records_skipped`` 1, ``data-slow-reader`` finished with a measured
  stall share, ``data-missing-shard`` refused by name before any device
  work, the checkpoint's ``stream_<step>.json`` sidecars; through the
  harness, ``data-stall`` exits 78 and ``--resume`` then consumes exactly
  the records not consumed, and over two gloo ranks a stall on one rank
  stops both at the same step; the rows pass JAX's ``validate_results``.
"""

import importlib.util
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu.analysis import validate_results as jvalid
from distributed_llm_training_benchmark_framework_tpu.data import prefetch as jprefetch
from distributed_llm_training_benchmark_framework_tpu.data import stream as jstream
from distributed_llm_training_benchmark_framework_tpu.faults import injection as jinj
from distributed_llm_training_benchmark_framework_tpu_torch.data import make_shards as tmake
from distributed_llm_training_benchmark_framework_tpu_torch.data import prefetch as tprefetch
from distributed_llm_training_benchmark_framework_tpu_torch.data import stream as tstream
from distributed_llm_training_benchmark_framework_tpu_torch.faults import injection as tinj
from distributed_llm_training_benchmark_framework_tpu_torch.runtime.checkpoint import (
    BenchmarkCheckpointer,
)
from distributed_llm_training_benchmark_framework_tpu_torch.telemetry import read_events
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
SHARDS = REPO / "tests" / "fixtures" / "shards"
SEQ = 16  # the fixture shards' record length (3 shards x 8 records, vocab 64)
# Tier S on the fixture: 2 records per step, fenced every 2 steps (the
# validator's step-time CV envelope holds per-step-synced rows to device
# stability).
SMALL = dict(tier="S", seq_len=SEQ, warmup_steps=2, device="cpu", sync_every=2,
             per_device_batch=1, grad_accum=2, heartbeat_sec=0)
ARM = f"zero2_ws1_seq{SEQ}_tierS"


# -- the shard format ------------------------------------------------------------


def test_writer_and_generator_write_jax_bytes(tmp_path):
    tokens = np.random.default_rng(3).integers(0, 100, (5, 12), dtype=np.int32)
    for mod, name in ((jstream, "j"), (tstream, "t")):
        mod.write_shard(str(tmp_path / name), tokens, shard_index=1, num_shards=4,
                        vocab_size=100, seed=9)
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()
    assert tstream.read_shard_header(str(tmp_path / "t")) == \
        jstream.read_shard_header(str(tmp_path / "j"))
    spec = importlib.util.spec_from_file_location(
        "make_tokenized_shards", REPO / "scripts" / "make_tokenized_shards.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    kw = dict(num_shards=3, records_per_shard=8, seq_len=SEQ, vocab_size=64, seed=7)
    want = script.make_shards(str(tmp_path / "js"), **kw)
    got = tmake.make_shards(str(tmp_path / "ts"), **kw)
    assert {k: v for k, v in got.items() if k != "generator"} == \
        {k: v for k, v in want.items() if k != "generator"}
    for i in range(3):
        name = tstream.shard_filename(i, 3)
        assert (tmp_path / "ts" / name).read_bytes() == (tmp_path / "js" / name).read_bytes()
        # The fixture shards are this generation.
        assert (tmp_path / "ts" / name).read_bytes() == (SHARDS / name).read_bytes()


def test_generator_runs_as_a_module(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_llm_training_benchmark_framework_tpu_torch.data"
         ".make_shards", "--out", str(tmp_path), "--num-shards", "2", "--records-per-shard",
         "4", "--seq-len", "8", "--vocab-size", "32"],
        capture_output=True, text=True, timeout=60, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(tmp_path)) == ["MANIFEST.json", tstream.shard_filename(0, 2),
                                            tstream.shard_filename(1, 2)]


# -- the stream against JAX's ------------------------------------------------------


def _injector(mod, spec):
    return mod.FaultInjector(mod.parse_fault_spec(spec), is_main=False) if spec else None


def _read_through(mod, inj_mod, spec, sizes):
    s = mod.ShardedTokenStream(str(SHARDS), seq_len=SEQ, injector=_injector(inj_mod, spec))
    out = [s.describe(), s.total_records]
    for n in sizes:
        out.append((s.next_batch(n).tolist(), s.cursor, s.records_skipped,
                    s.drain_quarantine()))
    s.seek(5)
    out.append((s.next_batch(3).tolist(), s.state_dict(), s.quarantine_ledger))
    s.close()
    return out


HOOKS = [None, "data-corrupt-record@5", "data-corrupt-record@26", "data-slow-reader@10:4"]


@pytest.mark.parametrize("spec", HOOKS, ids=[str(h) for h in HOOKS])
def test_stream_reads_match_jax(spec, monkeypatch):
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    # 7 + 9 + 11 records cross every shard boundary and wrap the epoch (24).
    want = _read_through(jstream, jinj, spec, (7, 9, 11))
    n_sleeps = len(slept)
    got = _read_through(tstream, tinj, spec, (7, 9, 11))
    assert got == want
    assert slept[n_sleeps:] == slept[:n_sleeps]
    if spec and "corrupt" in spec:
        assert want[-1][1]["records_skipped"] == 1 and want[-1][2][0]["reason"] == "crc_mismatch"


def _write_set(path, n=3, records=4, bad=None):
    path.mkdir()
    for i in range(n):
        tstream.write_shard(str(path / tstream.shard_filename(i, n)),
                            np.full((records, SEQ), i, np.int32), shard_index=i, num_shards=n,
                            vocab_size=64)
    if bad is not None:
        name = path / tstream.shard_filename(bad, n)
        raw = bytearray(name.read_bytes())
        header = tstream.read_shard_header(str(name))[1]
        for r in range(records):  # every record's payload byte: no valid neighbour
            raw[header + r * (4 + 4 * SEQ) + 4] ^= 0xFF
        name.write_bytes(bytes(raw))


ERRORS = ["missing-hook", "no-dir", "seq-mismatch", "bad-magic", "mixed-set", "all-corrupt",
          "empty-dir"]


@pytest.mark.parametrize("case", ERRORS)
def test_stream_errors_match_jax(case, tmp_path):
    data, seq, spec, read = str(SHARDS), SEQ, None, False
    if case == "missing-hook":
        spec = "data-missing-shard@1"
    elif case == "no-dir":
        data = str(tmp_path / "nowhere")
    elif case == "seq-mismatch":
        seq = 32
    elif case == "bad-magic":
        _write_set(tmp_path / "d")
        (tmp_path / "d" / tstream.shard_filename(2, 3)).write_bytes(b"NOTASHARD" * 4)
        data = str(tmp_path / "d")
    elif case == "mixed-set":
        _write_set(tmp_path / "d")
        tstream.write_shard(str(tmp_path / "d" / tstream.shard_filename(0, 2)),
                            np.zeros((2, SEQ), np.int32), shard_index=0, num_shards=2,
                            vocab_size=64)
        data = str(tmp_path / "d")
    elif case == "all-corrupt":
        _write_set(tmp_path / "d", bad=1)
        data, read = str(tmp_path / "d"), True
    else:
        (tmp_path / "d").mkdir()
        data = str(tmp_path / "d")
    errors = []
    for mod, inj in ((jstream, jinj), (tstream, tinj)):
        with pytest.raises(Exception) as e:
            s = mod.ShardedTokenStream(data, seq_len=seq, injector=_injector(inj, spec))
            if read:
                s.read_records(0, 12)
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0][0] == errors[1][0]
    if case not in ("seq-mismatch", "empty-dir"):  # they name each package's generator
        assert errors[0][1] == errors[1][1]
    if case == "missing-hook":
        assert "missing shard 1 of 3" in errors[1][1]


# -- the prefetcher against JAX's -----------------------------------------------------


def _jax_batches(steps, accum, gmicro, spec=None):
    s = jstream.ShardedTokenStream(str(SHARDS), seq_len=SEQ, injector=_injector(jinj, spec))
    p = jprefetch.HostPrefetcher(s, sharding=jax.sharding.SingleDeviceSharding(jax.devices()[0]),
                                 grad_accum=accum, global_micro=gmicro, seq_len=SEQ,
                                 start_step=0, stop_step=steps).start()
    out = [(np.asarray(arr), meta) for arr, meta, _ in (p.get(i, 10.0) for i in range(steps))]
    p.stop(join=True)
    return out


def _port_prefetcher(steps, accum, gmicro, spec=None, **kw):
    s = tstream.ShardedTokenStream(str(SHARDS), seq_len=SEQ, injector=_injector(tinj, spec))
    return tprefetch.HostPrefetcher(s, grad_accum=accum, global_micro=gmicro, seq_len=SEQ,
                                    start_step=0, stop_step=steps, device=torch.device("cpu"),
                                    injector=_injector(tinj, spec), **kw).start()


@pytest.mark.parametrize("spec", [None, "data-corrupt-record@9"], ids=["plain", "corrupt"])
def test_prefetcher_delivers_jax_batches_in_order(spec):
    steps, accum, gmicro = 8, 2, 2  # 32 records: the epoch wraps
    want = _jax_batches(steps, accum, gmicro, spec)
    whole = _port_prefetcher(steps, accum, gmicro, spec)
    # This rank's rows and columns: row 1 of each global micro-batch, the
    # second half of the sequence.
    part = _port_prefetcher(steps, accum, gmicro, spec, row0=1, micro=1, seq_shard=(1, 2))
    for step, (arr, meta) in enumerate(want):
        batch, got_meta, waited = whole.get(step, 10.0)
        assert batch.dtype == torch.int64 and waited >= 0
        np.testing.assert_array_equal(batch.numpy(), arr)
        assert got_meta == meta
        batch, got_meta, _ = part.get(step, 10.0)
        np.testing.assert_array_equal(batch.numpy(), arr[:, 1:2, SEQ // 2:])
        assert got_meta == meta
    whole.stop(join=True)
    part.stop(join=True)


def test_prefetcher_surfaces_errors_and_stalls(tmp_path):
    _write_set(tmp_path / "d", bad=1)
    s = tstream.ShardedTokenStream(str(tmp_path / "d"), seq_len=SEQ)
    p = tprefetch.HostPrefetcher(s, grad_accum=1, global_micro=2, seq_len=SEQ, start_step=0,
                                 stop_step=6, device=torch.device("cpu")).start()
    assert p.get(0, 10.0)[1]["cursor"] == 2 and p.get(1, 10.0)[1]["cursor"] == 4
    with pytest.raises(tstream.DataReadError, match="corrupt beyond substitution"):
        p.get(2, 10.0)  # records 4..5: shard 1, all corrupt
    stalled = _port_prefetcher(4, 1, 1, spec="data-stall@1:30")
    stalled.get(0, 10.0)
    with pytest.raises(tprefetch.DataStallTimeout) as e:
        stalled.get(1, 0.3)
    assert e.value.step == 1 and e.value.waited_sec >= 0.3
    t0 = time.perf_counter()
    stalled.stop(join=True)
    assert time.perf_counter() - t0 < 5 and not stalled._thread.is_alive()


# -- end to end at tier S ---------------------------------------------------------------


def _events(results):
    return read_events(str(Path(results) / f"telemetry_{ARM}.jsonl"))


def _valid(results, name):
    path = Path(results) / f"result_{ARM}.json"
    row = json.loads(path.read_text())
    return jvalid.validate_result(row, name) + jvalid.validate_telemetry(str(path), row, name)


@pytest.fixture(scope="module")
def streamed(tmp_path_factory):
    out = tmp_path_factory.mktemp("streamed")
    runs = {}
    for name, kw in {
        "straight": {},
        "healed": dict(sentinel=True, checkpoint_dir=str(out / "ck_healed"), checkpoint_every=2,
                       inject_fault="bitflip@5"),
        "corrupt": dict(inject_fault="data-corrupt-record@3", checkpoint_dir=str(out / "ck_c"),
                        checkpoint_every=4),
        "slow": dict(inject_fault="data-slow-reader@4:20"),
    }.items():
        losses, log = [], {}
        row = run_benchmark(steps=10, data_path=str(SHARDS), loss_log=losses,
                            results_dir=str(out / name), runtime_log=log, dropout=0.1, **kw,
                            **SMALL)
        runs[name] = (row, losses, log)
    return out, runs


def test_a_stream_run_publishes_its_cursor_and_stall_share(streamed):
    out, runs = streamed
    row, _, log = runs["straight"]
    assert row.data_mode == "stream" and (row.stream_cursor_start, row.stream_cursor_end) == (0, 20)
    assert row.records_consumed == 20 and row.records_skipped == 0
    assert 0.0 <= row.data_stall_frac <= 1.0 and len(log["data_wait_ms"]) == 10
    assert _valid(out / "straight", "straight") == []
    meta = next(e for e in _events(out / "straight") if e["event"] == "run_meta")
    windows = [e for e in _events(out / "straight") if e["event"] == "step_window"]
    assert all("data_wait_sec" in w and w["records_skipped"] == 0 for w in windows)
    assert meta.get("data_mode", meta.get("meta", {}).get("data_mode")) == "stream"


def test_a_rollback_and_replay_equal_the_straight_run_bit_for_bit(streamed):
    out, runs = streamed
    row, healed, _ = runs["healed"]
    _, straight, _ = runs["straight"]
    assert row.n_rollbacks == 1 and row.rollback_steps_replayed >= 1
    assert healed == straight  # fp32, dropout 0.1: the same records and masks
    assert (row.stream_cursor_start, row.stream_cursor_end) == (0, 20)
    assert _valid(out / "healed", "healed") == []


def test_a_corrupt_record_heals_with_one_skip(streamed):
    out, runs = streamed
    row, losses, _ = runs["corrupt"]
    assert row.records_skipped == 1 and len(losses) == 10
    events = [e for e in _events(out / "corrupt") if e["event"] == "data_corrupt_record"]
    assert len(events) == 1 and events[0]["global_index"] == 3
    assert events[0]["substitute_record"] == 2 and events[0]["reason"] == "crc_mismatch"
    side = BenchmarkCheckpointer(str(out / "ck_c")).read_stream_state(4)
    assert side == {"schema_version": 1, "cursor": 10, "records_skipped": 1,
                    "total_records": 24}
    assert _valid(out / "corrupt", "corrupt") == []


def test_a_slow_reader_degrades_and_finishes(streamed):
    """The run completes, its row valid; how much of the delay shows as a
    wait depends on the step's own time (the prefetcher reads ahead), so
    the wait itself is held in ``test_a_slow_reader_shows_in_the_wait``."""
    out, runs = streamed
    row, losses, _ = runs["slow"]
    assert len(losses) == 10 and 0.0 < row.data_stall_frac <= 1.0
    faults = [e for e in _events(out / "slow") if e["event"] == "fault_injected"]
    assert len(faults) == 1 and "+20 ms" in faults[0]["detail"]
    assert _valid(out / "slow", "slow") == []


def test_a_slow_reader_shows_in_the_wait():
    """A consumer that computes nothing waits for every slowed batch: 2
    records x 20 ms from step 2 (record 4) on."""
    p = _port_prefetcher(8, 2, 1, spec="data-slow-reader@4:20")
    waits = [p.get(step, 10.0)[2] for step in range(8)]
    p.stop(join=True)
    assert sum(waits[2:]) >= 0.8 * 6 * 2 * 0.020, waits


def test_a_missing_shard_is_refused_by_name_before_device_work(tmp_path):
    with pytest.raises(tstream.MissingShardError, match="missing shard 2 of 3"):
        run_benchmark(steps=4, data_path=str(SHARDS), inject_fault="data-missing-shard@2",
                      results_dir=str(tmp_path), **SMALL)
    events = read_events(str(tmp_path / f"telemetry_{ARM}.jsonl"))
    assert [e["phase"] for e in events if e["event"] == "run_aborted"] == ["init"]


@pytest.mark.parametrize("spec", ["data-stall@1", "data-corrupt-record@3",
                                  "data-slow-reader@1:5", "data-missing-shard@0"])
def test_data_faults_need_a_data_path(spec):
    with pytest.raises(ValueError, match="requires --data-path"):
        run_benchmark(steps=4, inject_fault=spec, **SMALL)


def test_a_stall_timeout_must_be_positive():
    with pytest.raises(ValueError, match="--data-stall-timeout-sec must be > 0"):
        run_benchmark(steps=4, data_path=str(SHARDS), data_stall_timeout_sec=0, **SMALL)


def test_sidecars_are_written_quarantined_and_collected(tmp_path):
    run_benchmark(steps=10, data_path=str(SHARDS), checkpoint_dir=str(tmp_path / "ck"),
                  checkpoint_every=2, telemetry=False, **SMALL)
    ckpt = BenchmarkCheckpointer(str(tmp_path / "ck"))
    assert ckpt.all_steps() == [6, 8, 9]
    assert sorted(n for n in os.listdir(tmp_path / "ck") if n.startswith("stream_")) == [
        "stream_6.json", "stream_8.json", "stream_9.json"]
    assert [ckpt.read_stream_state(s)["cursor"] for s in (6, 8, 9)] == [14, 18, 20]
    dest = ckpt.quarantine_step(9, "test")
    assert os.path.exists(os.path.join(dest, "stream_9.json"))
    assert ckpt.read_stream_state(9) is None


# -- the harness: exit 78 and the exact resume; a stall on one of two ranks ---------------


def _harness_cmd(results, ck, extra):
    return [sys.executable, "-m", "distributed_llm_training_benchmark_framework_tpu_torch.train"
            ".harness", "--device", "cpu", "--strategy", "zero2", "--tier", "S", "--seq-len",
            str(SEQ), "--per-device-batch", "1", "--grad-accum", "2", "--warmup-steps", "2",
            "--sync-every", "2", "--heartbeat-sec", "0", "--steps", "10", "--data-path",
            str(SHARDS), "--results-dir", str(results), "--checkpoint-dir", str(ck)] + extra


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "INJECT_FAULT"):
        env.pop(var, None)
    return env


def test_a_stall_exits_78_and_the_resume_consumes_the_rest(tmp_path):
    base = ["--world-size", "1"]
    stall = subprocess.run(
        _harness_cmd(tmp_path / "r", tmp_path / "ck", base + [
            "--inject-fault", "data-stall@6:60", "--data-stall-timeout-sec", "1"]),
        capture_output=True, text=True, timeout=180, cwd=REPO, env=_env())
    assert stall.returncode == 78, stall.stderr[-3000:]
    assert "DATA STALL" in stall.stdout and "Emergency checkpoint saved at step 5" in stall.stdout
    events = _events(tmp_path / "r")
    fatal = [e for e in events if e["event"] == "data_stall" and e["fatal"]]
    assert len(fatal) == 1 and fatal[0]["step"] == 6
    assert events[-1]["event"] == "run_aborted" and events[-1]["reason"] == "data_stall"
    beat = [json.loads(ln.split(" ", 1)[1]) for ln in stall.stdout.splitlines()
            if ln.startswith("BENCHMARK_HEARTBEAT ")][-1]
    assert beat["reason"] == "data_stall" and beat["emergency_checkpoint_step"] == 5
    assert BenchmarkCheckpointer(str(tmp_path / "ck")).read_stream_state(5)["cursor"] == 12
    back = subprocess.run(_harness_cmd(tmp_path / "r", tmp_path / "ck", base + ["--resume"]),
                          capture_output=True, text=True, timeout=180, cwd=REPO, env=_env())
    assert back.returncode == 0, back.stderr[-3000:]
    row = json.loads((tmp_path / "r" / f"result_{ARM}.json").read_text())
    # Steps 6..9 read exactly records 12..19: none repeated, none skipped.
    assert (row["resumed"], row["resume_step"]) == (True, 5)
    assert (row["stream_cursor_start"], row["stream_cursor_end"], row["records_consumed"]) == (
        12, 20, 8)
    assert _valid(tmp_path / "r", "resumed") == []


def test_a_stall_on_one_rank_stops_both_at_one_step(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        fault = ["--inject-fault", "data-stall@5:60"] if rank == 1 else []
        cmd = _harness_cmd(tmp_path / "r", tmp_path / "ck", [
            "--world-size", "2", "--num-processes", "2", "--rank", str(rank), "--master-port",
            str(port), "--data-stall-timeout-sec", "2"] + fault)
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [78, 78], [o[1][-2000:] for o in outs]
    for out, _ in outs:
        assert "starved the timed loop at step 5" in out
    assert BenchmarkCheckpointer(str(tmp_path / "ck")).all_steps() == [4]
