"""Start N harness ranks on this host and exit as one process, with their code.

    python -m distributed_llm_training_benchmark_framework_tpu_torch.runtime.launch \\
        --nproc 2 -- \\
        python -m distributed_llm_training_benchmark_framework_tpu_torch.train.harness \\
        --world-size 2 ...

The port runs one process per rank, where JAX's harness runs one process
over all its devices; so a supervised multi-rank run needs one parent whose
exit code is the ranks' code. ``torchrun`` is not that parent: when its
workers exit 75 it exits 1 and prints ``exitcode : 75`` only in its failure
summary, so a supervisor would class a preempted run as a crash and
cold-retry it instead of resuming it. This launcher:

- starts ``--nproc`` copies of the command, rank r with the harness's own
  ``--num-processes N --rank r --master-port P`` (P a free port on this
  host) and ``LOCAL_RANK=r``; with ``--nproc 1`` it runs the command as it
  is, in no group, as a world-1 harness runs alone;
- gives rank 0 its own stdout and sends the other ranks' stdout to its
  stderr, so the heartbeat and result lines on stdout have one writer, as
  under JAX's one process;
- forwards SIGTERM to every rank, so each rank's preemption guard gets its
  grace window;
- when a rank exits non-zero, gives the others :data:`DEFAULT_GRACE_SEC`
  to finish (the harness's preempt, hang and stall agreements stop every
  rank at one boundary, so they normally exit with the same code), then
  SIGKILLs any rank still running;
- exits with the first non-zero code (a signal death as 128 + the signal,
  the shell's convention), or 0 when every rank exited 0.

It imports nothing beyond the standard library, so it holds no device.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence, Tuple

LAUNCH_MODULE = "distributed_llm_training_benchmark_framework_tpu_torch.runtime.launch"
NPROC_FLAG = "--nproc"
DEFAULT_GRACE_SEC = 60.0
POLL_SEC = 0.05
STDERR_FD = 2

USAGE = ("usage: python -m distributed_llm_training_benchmark_framework_tpu_torch.runtime."
         "launch --nproc N -- cmd args...")


def free_port() -> int:
    """A TCP port on this host that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def set_flag(cmd: Sequence[str], flag: str, value: str) -> List[str]:
    """Replace ``flag``'s value in place (or append the pair)."""
    out = list(cmd)
    for i, tok in enumerate(out):
        if tok == flag and i + 1 < len(out):
            out[i + 1] = value
            return out
        if tok.startswith(flag + "="):
            out[i] = f"{flag}={value}"
            return out
    return out + [flag, value]


def rank_cmd(cmd: Sequence[str], nproc: int, rank: int, port: int) -> List[str]:
    """Rank ``rank``'s command line: the harness's group flags set."""
    out = set_flag(cmd, "--num-processes", str(nproc))
    out = set_flag(out, "--rank", str(rank))
    return set_flag(out, "--master-port", str(port))


def shell_code(rc: int) -> int:
    """A ``Popen.returncode`` as a shell reports it (-15 -> 143)."""
    return 128 - rc if rc < 0 else rc


def launch(cmd: Sequence[str], nproc: int, grace_sec: float = DEFAULT_GRACE_SEC) -> int:
    """Run ``nproc`` ranks of ``cmd`` to their end; returns the exit code."""
    if nproc < 1:
        raise ValueError(f"{NPROC_FLAG} must be >= 1, got {nproc}")
    if nproc == 1:
        cmds, envs = [list(cmd)], [None]
    else:
        port = free_port()
        cmds = [rank_cmd(cmd, nproc, r, port) for r in range(nproc)]
        envs = [dict(os.environ, LOCAL_RANK=str(r)) for r in range(nproc)]
    procs = [subprocess.Popen(c, env=e, stdout=None if r == 0 else STDERR_FD)
             for r, (c, e) in enumerate(zip(cmds, envs))]

    def _forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                except (ProcessLookupError, OSError):
                    pass

    prev = signal.signal(signal.SIGTERM, _forward)
    first_bad: Optional[int] = None
    deadline: Optional[float] = None
    try:
        while True:
            codes = [p.poll() for p in procs]
            for rc in codes:
                if rc not in (None, 0) and first_bad is None:
                    first_bad = shell_code(rc)
                    deadline = time.monotonic() + grace_sec
            if all(rc is not None for rc in codes):
                break
            if deadline is not None and time.monotonic() >= deadline:
                for r, p in enumerate(procs):
                    if p.poll() is None:
                        print(f"launch: rank {r} still running {grace_sec:g}s after a rank "
                              f"exited {first_bad}; killing it", file=sys.stderr)
                        p.kill()
                for p in procs:
                    p.wait()
                break
            time.sleep(POLL_SEC)
    finally:
        signal.signal(signal.SIGTERM, prev)
    return first_bad or 0


def parse_cli(argv: Sequence[str]) -> Tuple[int, List[str]]:
    """-> (nproc, cmd); ValueError on a malformed call."""
    nproc = None
    argv = list(argv)
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok == "--":
            cmd = argv[i + 1:]
            if not cmd:
                raise ValueError("no command after --")
            if nproc is None:
                raise ValueError(f"{NPROC_FLAG} is required")
            return nproc, cmd
        flag, eq, inline = tok.partition("=")
        if flag != NPROC_FLAG:
            raise ValueError(f"unknown flag {tok}")
        if eq:
            value, i = inline, i + 1
        elif i + 1 < len(argv):
            value, i = argv[i + 1], i + 2
        else:
            raise ValueError(f"{flag} needs a value")
        nproc = int(value)
    raise ValueError("missing -- separator before the command")


def main(argv: Optional[Sequence[str]] = None) -> int:
    try:
        nproc, cmd = parse_cli(sys.argv[1:] if argv is None else argv)
        return launch(cmd, nproc)
    except ValueError as e:
        print(f"launch: {e}\n{USAGE}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
