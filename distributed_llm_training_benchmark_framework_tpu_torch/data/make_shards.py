"""Generate tokenized record shards for the streaming input path.

    python -m distributed_llm_training_benchmark_framework_tpu_torch.data.make_shards \\
        --out DIR --num-shards 4 --records-per-shard 64 --seq-len 32 --vocab-size 512

Writes a complete ``shard_{i:05d}-of-{n:05d}.tokrec`` set (the format
``data/stream.py`` reads: magic, JSON header, CRC32-framed int32 records)
and a ``MANIFEST.json`` describing it. Deterministic: shard i's tokens come
from numpy's PCG64 seeded with ``seed + i``, so any shard can be made again
on its own. A numpy copy of the JAX package's
``scripts/make_tokenized_shards.py``: the same arguments give the same
bytes (the ``generator`` field of the manifest names this module).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .stream import shard_filename, write_shard


def make_shards(out_dir: str, *, num_shards: int, records_per_shard: int, seq_len: int,
                vocab_size: int, seed: int = 42) -> dict:
    """Write the shard set and MANIFEST.json; returns the manifest."""
    if num_shards <= 0 or records_per_shard <= 0:
        raise ValueError("num_shards and records_per_shard must be > 0")
    os.makedirs(out_dir, exist_ok=True)
    for i in range(num_shards):
        rng = np.random.default_rng(seed + i)
        tokens = rng.integers(0, vocab_size, size=(records_per_shard, seq_len), dtype=np.int32)
        write_shard(os.path.join(out_dir, shard_filename(i, num_shards)), tokens,
                    shard_index=i, num_shards=num_shards, vocab_size=vocab_size, seed=seed + i)
    manifest = {
        "schema_version": 1,
        "num_shards": num_shards,
        "records_per_shard": records_per_shard,
        "total_records": num_shards * records_per_shard,
        "seq_len": seq_len,
        "vocab_size": vocab_size,
        "seed": seed,
        "generator": "distributed_llm_training_benchmark_framework_tpu_torch.data.make_shards",
    }
    with open(os.path.join(out_dir, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")
    return manifest


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--num-shards", type=int, default=4)
    p.add_argument("--records-per-shard", type=int, default=64)
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--vocab-size", type=int, default=512)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)
    m = make_shards(args.out, num_shards=args.num_shards,
                    records_per_shard=args.records_per_shard, seq_len=args.seq_len,
                    vocab_size=args.vocab_size, seed=args.seed)
    print(f"Wrote {m['num_shards']} shards x {m['records_per_shard']} records (seq_len "
          f"{m['seq_len']}, vocab {m['vocab_size']}) -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
