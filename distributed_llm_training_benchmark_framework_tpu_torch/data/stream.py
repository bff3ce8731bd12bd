"""Fault-tolerant sharded streaming input: checksummed token records on disk.

Port of ``distributed_llm_training_benchmark_framework_tpu/data/stream.py``
(numpy only, so a copy: the same shard format, errors, cursor and
quarantine ledger, bit for bit). The durable half of the streaming input
path (``data/prefetch.py`` is the consumer half):

- **Checksummed records.** Every record carries a CRC32 over its payload
  (``data/make_shards.py`` writes the format). Bit-rot or a torn write is
  found at read time, never trained on as a garbage token id.
- **Skip-and-quarantine with a ledger.** A corrupt record's slot is filled
  by the nearest valid record of the same shard (deterministic, so every
  rank substitutes alike), and the quarantine ledger records (epoch,
  shard, offset, reason). ``records_skipped`` rides the result row and the
  telemetry.
- **Bounded retry with exponential backoff** on transient ``OSError`` s,
  then :class:`DataReadError`.
- **Loud missing-shard refusal.** Discovery proves the
  ``shard_{i}-of-{n}`` set complete and names a missing shard before any
  device work (the ``data-missing-shard@K`` fault pins it).
- **Exact-resume cursor.** The stream's position is one geometry-free
  number, ``cursor`` = global records delivered to training (epoch =
  cursor // total_records). The loop persists it in the checkpoint's
  ``stream_<step>.json`` sidecar, so a killed run resumes consuming
  precisely the records it had not consumed.

Addressing is random access by global record index (fixed-size records),
so each rank reads only the rows of its own batch shard.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..exit_codes import EXIT_DATA_STALL  # noqa: F401  (the harness's exit 78)

#: On-disk shard format magic + version (bump on any layout change; readers
#: refuse a newer magic rather than guess).
SHARD_MAGIC = b"TOKREC01"
#: ``shard_{i:05d}-of-{n:05d}.tokrec`` — the ``-of-`` count is what lets
#: discovery prove completeness instead of trusting whatever files exist.
SHARD_FILENAME_RE = re.compile(r"^shard_(\d{5})-of-(\d{5})\.tokrec$")
STREAM_STATE_SCHEMA_VERSION = 1

#: Per-record CRC32 header size (4 bytes, little-endian).
_CRC_BYTES = 4

#: Transient-read-error policy: attempts and the base backoff (doubled per
#: retry). Small because the reader sits on the hot input path — a mount
#: that needs more than ~3 tries is an incident, not a transient.
DEFAULT_READ_RETRIES = 3
DEFAULT_RETRY_BACKOFF_SEC = 0.05


class MissingShardError(ValueError):
    """The shard set is incomplete; the message names the missing shard."""


class DataReadError(OSError):
    """A record read failed past the bounded retry budget (or a shard is
    corrupt beyond substitution)."""


class DataStalled(Exception):
    """The timed loop starved waiting on the input path past the
    configured timeout. Carries (stalled_step, waited_sec, saved_step);
    the harness maps it to :data:`EXIT_DATA_STALL`. The message only
    claims a checkpoint when one was actually committed — a stall before
    the first eligible boundary (or a failed emergency save) must not
    misdirect the operator toward a checkpoint that does not exist."""

    def __init__(self, step: int, waited_sec: float,
                 saved_step: Optional[int] = None):
        self.step = step
        self.waited_sec = waited_sec
        self.saved_step = saved_step
        tail = (
            f"emergency checkpoint at step {saved_step} + stream sidecar "
            "written — retry with --resume"
            if saved_step is not None else
            "no emergency checkpoint was committed (stalled before the "
            "first eligible boundary, or the save failed) — a retry "
            "resumes from the newest prior checkpoint, or cold-starts"
        )
        super().__init__(
            f"input path starved the timed loop at step {step} "
            f"({waited_sec:.1f}s past the data-stall timeout); {tail}"
        )


def shard_filename(index: int, num_shards: int) -> str:
    return f"shard_{index:05d}-of-{num_shards:05d}.tokrec"


def write_shard(
    path: str,
    tokens: np.ndarray,
    *,
    shard_index: int,
    num_shards: int,
    vocab_size: int,
    seed: int = 0,
) -> None:
    """Write one shard: magic + JSON header + CRC32-framed int32 records.

    ``tokens`` is ``(n_records, seq_len)`` integer data. Records are
    fixed-size (CRC + seq_len * 4 bytes), which is what makes the reader's
    random access closed-form. Written tmp+rename so a crashed generator
    never leaves a half-shard that discovery would accept.
    """
    tokens = np.ascontiguousarray(tokens, dtype=np.int32)
    n_records, seq_len = tokens.shape
    header = json.dumps({
        "schema_version": 1,
        "shard_index": shard_index,
        "num_shards": num_shards,
        "n_records": int(n_records),
        "seq_len": int(seq_len),
        "vocab_size": int(vocab_size),
        "dtype": "int32",
        "seed": int(seed),
    }, sort_keys=True).encode("ascii")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(SHARD_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        for row in tokens:
            payload = row.tobytes()
            f.write(struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF))
            f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_shard_header(path: str) -> Tuple[Dict[str, Any], int]:
    """-> (header dict, payload byte offset of record 0). Refuses loudly
    on a wrong magic — a truncated/foreign file must not read as data."""
    with open(path, "rb") as f:
        magic = f.read(len(SHARD_MAGIC))
        if magic != SHARD_MAGIC:
            raise DataReadError(
                f"{path}: bad shard magic {magic!r} (expected "
                f"{SHARD_MAGIC!r}) — not a tokenized record shard, or torn"
            )
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode("ascii"))
    return header, len(SHARD_MAGIC) + 4 + hlen


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    index: int
    path: str
    n_records: int
    seq_len: int
    data_offset: int  # byte offset of record 0
    record_bytes: int  # CRC + payload


class ShardedTokenStream:
    """Deterministic random-access reader over a complete shard set.

    Thread model: all reads happen on the prefetch thread
    (``data/prefetch.py``); the quarantine ledger is the one shared piece
    of state and is drained by the main thread at sync-window boundaries
    (so its telemetry events land at boundaries) — hence the lock.

    ``injector`` is the chaos :class:`faults.FaultInjector` (or None): its
    ``data_missing_shard`` / ``data_corrupt_payload`` /
    ``data_read_delay_sec`` hooks make the data-fault matrix
    deterministic without ever mutating the shard files themselves.
    """

    def __init__(
        self,
        data_dir: str,
        *,
        seq_len: Optional[int] = None,
        injector: Any = None,
        read_retries: int = DEFAULT_READ_RETRIES,
        retry_backoff_sec: float = DEFAULT_RETRY_BACKOFF_SEC,
    ):
        self.data_dir = data_dir
        self.injector = injector
        self.read_retries = int(read_retries)
        self.retry_backoff_sec = float(retry_backoff_sec)
        self.cursor = 0  # records DELIVERED to training (global, monotonic)
        self.records_skipped = 0
        self._ledger: List[Dict[str, Any]] = []
        self._ledger_drained = 0
        self._lock = threading.Lock()
        self._files: Dict[int, Any] = {}  # shard index -> open file handle
        self.shards = self._discover()
        self.seq_len = self.shards[0].seq_len
        if seq_len is not None and seq_len != self.seq_len:
            raise ValueError(
                f"--data-path shards carry seq_len={self.seq_len} but the "
                f"run requested seq_len={seq_len}; regenerate the shards "
                "(python -m "
                "distributed_llm_training_benchmark_framework_tpu_torch.data.make_shards) or "
                "match --seq-len"
            )
        #: Cumulative record-count boundaries for global-index -> shard
        #: mapping (supports unequal shard sizes via searchsorted).
        self._bounds = np.cumsum([s.n_records for s in self.shards])
        self.total_records = int(self._bounds[-1])

    # ------------------------------------------------------------------
    # Discovery
    # ------------------------------------------------------------------

    def _discover(self) -> List[ShardInfo]:
        if not os.path.isdir(self.data_dir):
            raise MissingShardError(
                f"--data-path {self.data_dir} is not a directory"
            )
        found: Dict[int, str] = {}
        declared_n: Optional[int] = None
        for path in sorted(glob.glob(os.path.join(self.data_dir, "shard_*.tokrec"))):
            m = SHARD_FILENAME_RE.match(os.path.basename(path))
            if not m:
                continue
            idx, n = int(m.group(1)), int(m.group(2))
            if declared_n is None:
                declared_n = n
            elif n != declared_n:
                raise MissingShardError(
                    f"{self.data_dir}: mixed shard sets ({n} vs "
                    f"{declared_n} in the -of- counts) — one directory, "
                    "one generation"
                )
            found[idx] = path
        if not found or declared_n is None:
            raise MissingShardError(
                f"no shard_*-of-*.tokrec files under {self.data_dir} "
                "(generate shards with python -m "
                "distributed_llm_training_benchmark_framework_tpu_torch.data.make_shards)"
            )
        # Chaos hook: the data-missing-shard@K arm withholds shard K from
        # discovery, so the refusal below fires exactly as it would for a
        # real hole — loud, named, pre-dispatch.
        withheld = (
            self.injector.data_missing_shard()
            if self.injector is not None
            and hasattr(self.injector, "data_missing_shard") else None
        )
        if withheld is not None:
            found.pop(withheld, None)
        missing = [i for i in range(declared_n) if i not in found]
        if missing:
            raise MissingShardError(
                f"incomplete shard set under {self.data_dir}: missing "
                f"shard {missing[0]} of {declared_n} (expected "
                f"{shard_filename(missing[0], declared_n)}); refusing to "
                "train on a silently truncated corpus"
            )
        shards: List[ShardInfo] = []
        for idx in range(declared_n):
            header, data_offset = read_shard_header(found[idx])
            if int(header.get("shard_index", idx)) != idx:
                raise DataReadError(
                    f"{found[idx]}: header shard_index="
                    f"{header.get('shard_index')} does not match its "
                    f"filename index {idx}"
                )
            seq = int(header["seq_len"])
            shards.append(ShardInfo(
                index=idx, path=found[idx],
                n_records=int(header["n_records"]), seq_len=seq,
                data_offset=data_offset,
                record_bytes=_CRC_BYTES + seq * 4,
            ))
        if len({s.seq_len for s in shards}) != 1:
            raise DataReadError(
                f"{self.data_dir}: shards disagree on seq_len "
                f"({sorted({s.seq_len for s in shards})}) — one directory, "
                "one generation"
            )
        return shards

    def describe(self) -> str:
        return (
            f"{len(self.shards)} shards, {self.total_records} records x "
            f"seq_len {self.seq_len} under {self.data_dir}"
        )

    # ------------------------------------------------------------------
    # Exact-resume state
    # ------------------------------------------------------------------

    def seek(self, cursor: int) -> None:
        """Position the stream at a delivered-records cursor (>= 0)."""
        if cursor < 0:
            raise ValueError(f"stream cursor must be >= 0, got {cursor}")
        self.cursor = int(cursor)

    def state_dict(self) -> Dict[str, Any]:
        """The exact-resume iterator state (checkpoint-sidecar payload)."""
        return {
            "schema_version": STREAM_STATE_SCHEMA_VERSION,
            "cursor": int(self.cursor),
            "records_skipped": int(self.records_skipped),
            "total_records": int(self.total_records),
        }

    # ------------------------------------------------------------------
    # Reads
    # ------------------------------------------------------------------

    def _file(self, shard: ShardInfo):
        f = self._files.get(shard.index)
        if f is None:
            f = open(shard.path, "rb")
            self._files[shard.index] = f
        return f

    def _locate(self, disk_index: int) -> Tuple[ShardInfo, int]:
        s = int(np.searchsorted(self._bounds, disk_index, side="right"))
        shard = self.shards[s]
        prev = int(self._bounds[s - 1]) if s > 0 else 0
        return shard, disk_index - prev

    def _read_span(self, shard: ShardInfo, offset: int, n: int) -> bytes:
        """``n`` contiguous framed records' bytes in ONE seek+read, with
        bounded retry/backoff on transient OSErrors (and a handle re-open
        per retry — a gone-stale NFS handle is the classic transient).
        Records are fixed-size frames, so batch reads are one contiguous
        span per shard — per-record round trips on a network filesystem
        would land directly in the measured data_stall_frac."""
        pos = shard.data_offset + offset * shard.record_bytes
        want = n * shard.record_bytes
        last_err: Optional[OSError] = None
        for attempt in range(self.read_retries + 1):
            try:
                f = self._file(shard)
                f.seek(pos)
                buf = f.read(want)
                if len(buf) != want:
                    raise OSError(
                        f"short read ({len(buf)} of {want} bytes) at "
                        f"record {offset}"
                    )
                return buf
            except OSError as e:
                last_err = e
                self._files.pop(shard.index, None)
                if attempt < self.read_retries:
                    time.sleep(self.retry_backoff_sec * (2 ** attempt))
        raise DataReadError(
            f"{shard.path}: record(s) {offset}..{offset + n - 1} "
            f"unreadable after {self.read_retries + 1} attempts "
            f"({last_err})"
        )

    def _read_raw(self, shard: ShardInfo, offset: int) -> bytes:
        """One framed record's bytes (the substitution path's unit read)."""
        return self._read_span(shard, offset, 1)

    def _decode(self, shard: ShardInfo, offset: int,
                raw: bytes) -> Optional[np.ndarray]:
        """CRC-verify + decode one framed record; None on checksum fail."""
        (crc,) = struct.unpack("<I", raw[:_CRC_BYTES])
        payload = raw[_CRC_BYTES:]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            return None
        return np.frombuffer(payload, dtype=np.int32).copy()

    def _substitute(self, shard: ShardInfo, bad_offset: int) -> Tuple[int, np.ndarray]:
        """The nearest VALID record in the same shard (previous first,
        then forward) — deterministic, so every host fills the slot with
        identical content. Raises DataReadError when the whole shard is
        corrupt (substitution must not loop forever on dead data)."""
        candidates = list(range(bad_offset - 1, -1, -1)) + list(
            range(bad_offset + 1, shard.n_records)
        )
        for off in candidates:
            row = self._decode(shard, off, self._read_raw(shard, off))
            if row is not None:
                return off, row
        raise DataReadError(
            f"{shard.path}: every record failed its checksum — the shard "
            "is corrupt beyond substitution; regenerate it"
        )

    def _deliver(self, shard: ShardInfo, offset: int, raw: bytes,
                 global_index: int) -> np.ndarray:
        """Decode-or-heal one framed record: injector hooks, CRC verify,
        and the substitution + ledger path on a mismatch."""
        inj = self.injector
        if inj is not None and hasattr(inj, "data_read_delay_sec"):
            delay = inj.data_read_delay_sec(global_index)
            if delay > 0:
                time.sleep(delay)
        if inj is not None and hasattr(inj, "data_corrupt_payload"):
            raw = raw[:_CRC_BYTES] + inj.data_corrupt_payload(
                global_index, raw[_CRC_BYTES:]
            )
        row = self._decode(shard, offset, raw)
        if row is None:
            sub_off, row = self._substitute(shard, offset)
            with self._lock:
                self.records_skipped += 1
                self._ledger.append({
                    "epoch": int(global_index // self.total_records),
                    "shard": shard.index,
                    "record": int(offset),
                    "global_index": int(global_index),
                    "reason": "crc_mismatch",
                    "substitute_record": int(sub_off),
                })
        return row

    def _read_one(self, global_index: int) -> np.ndarray:
        """One delivered record by global index, healing corruption."""
        shard, offset = self._locate(global_index % self.total_records)
        return self._deliver(shard, offset, self._read_raw(shard, offset),
                             global_index)

    def read_records(self, start: int, stop: int) -> np.ndarray:
        """Records ``[start, stop)`` in the global delivered-index space
        (epoch wrap handled) as an ``(stop-start, seq_len)`` int32 array.

        Reads are batched: each contiguous run of records inside one
        shard is ONE seek+read (fixed-size frames make the span closed
        form), then CRC-verified per frame — on a network filesystem the
        per-record round trips this avoids would otherwise inflate the
        very data_stall_frac the gate polices.
        """
        if stop < start:
            raise ValueError(f"bad record range [{start}, {stop})")
        out = np.empty((stop - start, self.seq_len), dtype=np.int32)
        i = 0
        g = start
        while g < stop:
            disk_index = g % self.total_records
            shard, offset = self._locate(disk_index)
            run = min(
                stop - g,                      # what the caller wants
                shard.n_records - offset,      # what this shard holds
                self.total_records - disk_index,  # this epoch's remainder
            )
            span = self._read_span(shard, offset, run)
            rb = shard.record_bytes
            for k in range(run):
                out[i] = self._deliver(
                    shard, offset + k, span[k * rb:(k + 1) * rb], g + k
                )
                i += 1
            g += run
        return out

    def next_batch(self, n: int) -> np.ndarray:
        """The next ``n`` records at the cursor; advances it."""
        batch = self.read_records(self.cursor, self.cursor + n)
        self.cursor += n
        return batch

    # ------------------------------------------------------------------
    # Quarantine ledger
    # ------------------------------------------------------------------

    def drain_quarantine(self) -> List[Dict[str, Any]]:
        """Ledger entries added since the last drain (main-thread side:
        the train loop emits one ``data_corrupt_record`` telemetry event
        per entry at its next sync-window boundary)."""
        with self._lock:
            new = self._ledger[self._ledger_drained:]
            self._ledger_drained = len(self._ledger)
            return list(new)

    @property
    def quarantine_ledger(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ledger)

    def close(self) -> None:
        for f in self._files.values():
            try:
                f.close()
            except OSError:
                pass
        self._files.clear()
