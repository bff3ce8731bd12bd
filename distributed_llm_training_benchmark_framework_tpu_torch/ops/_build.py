"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` compiles, on first use, into its own shared library with
a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <name>.so csrc/<name>.cu

All sources compile in parallel, one nvcc each. The libraries go into
``<repo>/build/torch_kernels/<hash of every csrc file>/``, so an edited
source gets a fresh directory and an unchanged one is reused. ptxas's
register / shared-memory / spill report lands beside each library as
``<name>.ptxas.txt``.

Nothing here runs at import time: ``load()`` is called by the kernel
wrappers the first time they launch.

``LAUNCHES`` is the one record of kernel launches, one count per kernel
mode: a wrapper calls ``launched`` where it launches its kernel and nowhere
else, and ``reset_launch_counts`` zeroes them all. A process whose
environment names a directory in ``KERNEL_LAUNCHES_DIR`` writes its counts
there as ``launches_<pid>.json`` when it exits, once it has launched a
kernel, so a parent can count the launches of the processes it started.
"""

from __future__ import annotations

import atexit
import collections
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# Wall seconds of the build that populated _libs (0.0 when every library
# was already on disk); chip_smoke.py prints it.
build_seconds: Optional[float] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32
# C signatures of every entry point, by library.
SIGNATURES = {
    "flash_fwd": {
        "flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _U, _U, _F, _P],
        "flash_fwd_bhv": [_P] * 6 + [_I] * 5 + [_F, _U, _U, _F, _P],
        "flash_fwd_error_string": [_I],
    },
    "flash_bwd": {
        "flash_bwd_dq": [_P] * 10 + [_I] * 6 + [_F, _U, _U, _F, _P],
        "flash_bwd_dkv": [_P] * 11 + [_I] * 6 + [_F, _U, _U, _F, _P],
        "flash_bwd_error_string": [_I],
    },
    "ring_fwd": {
        "ring_fwd_block": [_P] * 9 + [_I] * 5 + [_F, _U, _U, _F, _P],
        "ring_fwd_error_string": [_I],
    },
    "fwd_variants": {
        **{fn: [_P] * 4 + [_I] * 3 + [_F, _P] for fn in (
            "fwd_current", "fwd_headpair", "fwd_kt", "fwd_matmul_only", "fwd_qscaled")},
        "fwd_variants_error_string": [_I],
    },
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
        "/usr/local/cuda/bin): the attention kernels cannot be built"
    )


def source_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def _compile_all(out_dir: Path) -> None:
    """Run one nvcc per source, all at once; raise with the compiler's output
    if any fails. Each library is written to a temporary name and renamed,
    so a reader never sees a half-written file."""
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SIGNATURES:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out_dir / f"{name}.so")
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))


def load() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library; idempotent."""
    global build_seconds
    with _lock:
        if _libs:
            return _libs
        out_dir = build_dir()
        t0 = time.perf_counter()
        if not all((out_dir / f"{n}.so").exists() for n in SIGNATURES):
            _compile_all(out_dir)
            build_seconds = time.perf_counter() - t0
        else:
            build_seconds = 0.0
        for name, fns in SIGNATURES.items():
            lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
            for fn, argtypes in fns.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_char_p if fn.endswith("_error_string") else ctypes.c_int
            _libs[name] = lib
        return _libs


LAUNCHES: Dict[str, int] = collections.Counter()
LAUNCHES_DIR_ENV = "KERNEL_LAUNCHES_DIR"
_dump_armed = False


def _dump_launches(directory: str) -> None:
    with open(os.path.join(directory, f"launches_{os.getpid()}.json"), "w") as f:
        json.dump(dict(LAUNCHES), f)


def launched(mode: str) -> None:
    """Count one launch of a kernel mode (e.g. ``flash_bwd_dq_fp32``)."""
    global _dump_armed
    LAUNCHES[mode] += 1
    if not _dump_armed:
        _dump_armed = True
        directory = os.environ.get(LAUNCHES_DIR_ENV)
        if directory:
            atexit.register(_dump_launches, directory)


def reset_launch_counts() -> None:
    """Zero the count of every kernel mode."""
    LAUNCHES.clear()


def check(lib_name: str, code: int, what: str) -> None:
    """Raise if a C entry returned a nonzero cudaError_t."""
    if code != 0:
        msg = getattr(_libs[lib_name], f"{lib_name}_error_string")(code)
        raise RuntimeError(
            f"{what}: CUDA error {code} ({msg.decode() if msg else '?'})"
        )
