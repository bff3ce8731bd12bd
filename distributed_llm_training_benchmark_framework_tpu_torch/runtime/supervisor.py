"""Elastic fleet supervisor: policy-driven recovery for one benchmark arm.

    python -m distributed_llm_training_benchmark_framework_tpu_torch.runtime.supervisor \
        --policy configs/recovery_policy.json --resume-flag --resume \
        --drop-on-retry --inject-fault [--chaos lose-host@2] -- \
        python -m distributed_llm_training_benchmark_framework_tpu_torch.runtime.launch \
        --nproc 2 -- python -m distributed_llm_training_benchmark_framework_tpu_torch.train.harness \
        --world-size 2 --device cpu ... --checkpoint-dir CK

Port of ``distributed_llm_training_benchmark_framework_tpu/runtime/supervisor.py``:
the same classes, policy, backoff, chaos grammar, argv surgery, ledger,
stamp and CLI. What differs, and why:

- **The probe.** JAX's runs ``jax.device_count()`` in a throwaway
  subprocess; the port's runs ``torch.cuda.device_count()`` in one, so the
  child owns CUDA and the supervisor never imports torch.
  ``SUPERVISOR_DEVICE_COUNT`` still overrides, and a failed probe is still
  None ("no information, no shrink"). When the child runs with ``--device
  cpu`` the inventory is the gloo ranks the host can start, one per core
  this process may run on (``os.sched_getaffinity``), with no subprocess.
  JAX's CPU probe reports its forced host device count (8 in its tests),
  at least the saved world, so a CPU run never shrinks or stays shrunk on
  the probe's word in either package: only ``lose-host`` / ``regain-host``
  and ``SUPERVISOR_DEVICE_COUNT`` move its geometry (on a host with fewer
  cores than the saved world the port's CPU probe would shrink it).
- **World size is a process count.** A world-N port child is
  ``runtime.launch --nproc N -- <harness>``: the launcher starts the N
  ranks, forwards SIGTERM to each, and exits with the ranks' code
  (``torchrun`` exits 1 for ranks that exit 75). ``resume-shrunk`` rewrites
  the launcher's ``--nproc`` together with ``--world-size``, since the
  harness refuses a world size other than its group's.

``scripts/with_retries.sh`` (the chaos-harness orchestration core since
the elastic-resilience round) treated every retryable exit identically:
fixed retry budget, fixed backoff, resume-and-pray. That is the right
*mechanism* but the wrong *brain* for a fleet — a preemption on a pod
slice that lost a host needs a SMALLER geometry, not the same one; a
deterministic refusal must never burn backoff; a crash may deserve a
cold retry rather than a resume into the state that crashed it. This
module closes the classify -> decide -> recover loop in one place:

- **Classify**: every child exit is mapped against the central exit-code
  registry (``faults.EXIT_PREEMPTED`` 75, ``EXIT_HUNG`` 76,
  ``EXIT_NOTHING_TO_RESUME`` 77, ``EXIT_DATA_STALL`` 78; 0 = ok,
  anything else — including signal deaths — = crash). No integer
  literals: the constants are imported from ``exit_codes``.
- **Decide**: a declarative policy (``configs/recovery_policy.json``)
  maps each class to an action in {resume, resume-shrunk, cold-retry,
  give-up} with a bounded per-class budget, plus exponential backoff
  with *deterministic* jitter (sha256 of arm|attempt — reproducible, so
  a chaos run's retry timeline is part of its identity). The legacy
  ``MAX_ARM_RETRIES`` / ``RETRY_BACKOFF_SEC`` env contract maps onto an
  equivalent policy when no policy file is given, so the
  ``with_retries.sh`` shim is a drop-in delegation.
- **Recover**: ``resume`` re-runs with the resume flag appended and the
  injected chaos fault dropped (flag + ``INJECT_FAULT`` env — one fault,
  one firing). ``resume-shrunk`` additionally probes device inventory
  before the attempt and, when capacity dropped below the checkpoint's
  saved geometry, rewrites ``--world-size`` to the largest
  divisor-legal geometry (the data axis shrinks; the model/seq/pipe/
  expert footprint is fixed) read from the ``geometry_<step>.json``
  sidecar — the elastic reshard-restore does the rest — and
  *regrows* back to the original geometry when capacity returns.
  ``cold-retry`` re-runs the original argv unchanged (minus the fault).
  ``give-up`` stops immediately with the child's real code.

Every attempt is recorded in an append-only ``supervision.json`` ledger
beside the results (attempts are only ever appended; the file is
rewritten atomically). After a recovered run completes, the final
result row is stamped with a ``supervision`` summary so the recovery
history flows into metrics.csv, the report, and the regress
never-baseline set (a supervised-recovered row is a stitched
measurement, not a clean one). The child sees
``BENCH_SUPERVISED_ATTEMPT`` in its env and carries the attempt number
into its telemetry ``run_meta``/heartbeats.

SIGTERM semantics (bash-as-PID-1 heritage, docker/entrypoint.sh): the
supervisor forwards SIGTERM to the running child so the harness's
preemption guard gets its grace window, and exits 143 itself when the
signal lands between attempts — identical to the old wrapper's
trap-and-forward contract.

Supervisor-level chaos (between-attempt faults, the counterpart of
``faults/injection.py``'s in-run specs):

- ``lose-host@A[:N]`` — from attempt A on, the device-inventory probe
  reports N devices (default: half the saved world size): a capacity
  drop between attempts, the shrink-resume proving ground.
- ``regain-host@B`` — from attempt B on, the capacity cap is lifted:
  the regrow path's proving ground.
- ``preempt-storm@K`` — keep the injected fault armed through attempt
  K (the drop-on-retry scrub is deferred), so a ``sigterm@N`` preempts
  the run again and again: the bounded-budget proving ground.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import re
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..exit_codes import (
    EXIT_DATA_STALL,
    EXIT_HUNG,
    EXIT_NOTHING_TO_RESUME,
    EXIT_PREEMPTED,
)
from .launch import LAUNCH_MODULE, NPROC_FLAG
from .launch import set_flag as _set_flag  # JAX's _set_flag, shared with the launcher

SUPERVISION_SCHEMA_VERSION = 1
LEDGER_NAME = "supervision.json"

#: Exit classes (the classify half of the loop). ``ok`` and
#: ``nothing-to-resume`` are terminal by construction; the others are
#: policy decisions.
EXIT_CLASSES = (
    "ok", "preempted", "hung", "nothing-to-resume", "data_stall", "crash",
)
#: Recovery actions a policy may assign to a class.
ACTIONS = ("resume", "resume-shrunk", "cold-retry", "give-up")
#: Supervisor-level (between-attempt) chaos kinds.
SUPERVISOR_FAULT_KINDS = ("lose-host", "regain-host", "preempt-storm")

#: Ceiling on the exponential backoff (seconds) regardless of policy.
BACKOFF_CAP_SEC = 600.0


class PolicyError(ValueError):
    """The recovery policy is malformed; the message names the field."""


# ---------------------------------------------------------------------------
# Classification
# ---------------------------------------------------------------------------


def classify_exit(rc: int) -> str:
    """Map one child exit code onto the exit-class registry.

    Negative codes are signal deaths (subprocess convention) and land in
    ``crash`` — a SIGKILLed child left no classification of its own, and
    the emergency-checkpoint trail (if any) is on disk either way.
    """
    if rc == 0:
        return "ok"
    if rc == EXIT_PREEMPTED:
        return "preempted"
    if rc == EXIT_HUNG:
        return "hung"
    if rc == EXIT_NOTHING_TO_RESUME:
        return "nothing-to-resume"
    if rc == EXIT_DATA_STALL:
        return "data_stall"
    return "crash"


# ---------------------------------------------------------------------------
# Policy
# ---------------------------------------------------------------------------


def default_policy_from_env(env: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """The legacy ``MAX_ARM_RETRIES``/``RETRY_BACKOFF_SEC`` contract as a
    policy object — what the ``with_retries.sh`` delegation runs under
    when no policy file is given. Every retryable class resumes with the
    same budget and backoff base, jitter off: byte-for-byte the old
    wrapper's behaviour when a single class is failing."""
    env = os.environ if env is None else env
    retries = int(env.get("MAX_ARM_RETRIES", "1"))
    backoff = float(env.get("RETRY_BACKOFF_SEC", "5"))
    classes = {
        c: {"action": "resume", "max_attempts": retries}
        for c in ("preempted", "hung", "data_stall", "crash")
    }
    classes["nothing-to-resume"] = {"action": "give-up", "max_attempts": 0}
    return {
        "schema_version": 1,
        "backoff_base_sec": backoff,
        "backoff_max_sec": BACKOFF_CAP_SEC,
        "jitter_frac": 0.0,
        "classes": classes,
    }


def load_policy(path: Optional[str]) -> Tuple[Dict[str, Any], str]:
    """-> (validated policy, source description). ``path`` None falls
    back to the env-derived legacy policy."""
    if not path:
        return validate_policy(default_policy_from_env()), "env"
    with open(path) as f:
        policy = json.load(f)
    return validate_policy(policy), f"file:{path}"


def validate_policy(policy: Dict[str, Any]) -> Dict[str, Any]:
    """Refuse a malformed policy loudly — a typo'd action name must not
    silently become 'give-up at the first fault'."""
    if not isinstance(policy, dict):
        raise PolicyError("recovery policy must be a JSON object")
    if int(policy.get("schema_version", 0)) != 1:
        raise PolicyError(
            f"recovery policy schema_version "
            f"{policy.get('schema_version')!r} is not 1"
        )
    classes = policy.get("classes")
    if not isinstance(classes, dict) or not classes:
        raise PolicyError("recovery policy needs a non-empty 'classes' map")
    for name, spec in classes.items():
        if name not in EXIT_CLASSES or name == "ok":
            raise PolicyError(
                f"unknown exit class {name!r} (expected one of "
                f"{[c for c in EXIT_CLASSES if c != 'ok']})"
            )
        action = spec.get("action")
        if action not in ACTIONS:
            raise PolicyError(
                f"class {name!r}: action {action!r} is not one of {ACTIONS}"
            )
        budget = spec.get("max_attempts", 0)
        if not isinstance(budget, int) or budget < 0:
            raise PolicyError(
                f"class {name!r}: max_attempts must be a non-negative "
                f"integer, got {budget!r}"
            )
    for key in ("backoff_base_sec", "backoff_max_sec", "jitter_frac"):
        if key in policy and float(policy[key]) < 0:
            raise PolicyError(f"{key} must be >= 0")
    policy.setdefault("backoff_base_sec", 5.0)
    policy.setdefault("backoff_max_sec", BACKOFF_CAP_SEC)
    policy.setdefault("jitter_frac", 0.1)
    return policy


def backoff_sec(
    policy: Dict[str, Any], *, n_recoveries: int, token: str,
) -> float:
    """Exponential backoff with deterministic jitter.

    ``n_recoveries`` is how many recoveries THIS class has already spent
    (the first retry backs off ``base``, the second ``2*base``, ...).
    Jitter is derived from sha256(token) so a given arm's retry timeline
    is reproducible — chaos runs assert on the ledger, and a
    wall-clock-seeded jitter would make the ledger flaky.
    """
    base = float(policy.get("backoff_base_sec", 5.0))
    cap = float(policy.get("backoff_max_sec", BACKOFF_CAP_SEC))
    raw = min(base * (2 ** max(n_recoveries, 0)), cap)
    frac = float(policy.get("jitter_frac", 0.0))
    if frac <= 0 or raw <= 0:
        return raw
    digest = hashlib.sha256(token.encode("utf-8")).digest()
    unit = int.from_bytes(digest[:8], "big") / float(1 << 64)  # [0, 1)
    return raw * (1.0 + frac * unit)


# ---------------------------------------------------------------------------
# Supervisor-level chaos specs
# ---------------------------------------------------------------------------


def parse_supervisor_chaos(specs: Sequence[str]) -> Dict[str, Any]:
    """Parse ``lose-host@A[:N]`` / ``regain-host@B`` / ``preempt-storm@K``
    specs into one chaos-state dict. Same loud-grammar posture as
    ``faults.parse_fault_spec``: an unknown kind or malformed step is a
    refusal, never a silently inert injection."""
    chaos: Dict[str, Any] = {}
    for spec in specs:
        if not spec:
            continue
        kind, _, rest = spec.partition("@")
        if kind not in SUPERVISOR_FAULT_KINDS:
            raise ValueError(
                f"unknown supervisor chaos kind {kind!r} in {spec!r} "
                f"(expected one of {SUPERVISOR_FAULT_KINDS})"
            )
        step_s, _, arg = rest.partition(":")
        try:
            at = int(step_s)
        except ValueError:
            raise ValueError(
                f"supervisor chaos {spec!r}: '@' must be followed by an "
                "attempt number"
            )
        if at < 1:
            raise ValueError(
                f"supervisor chaos {spec!r}: attempt must be >= 1"
            )
        if kind == "lose-host":
            chaos["lose_host_at"] = at
            chaos["lose_host_devices"] = int(arg) if arg else None
        elif kind == "regain-host":
            if arg:
                raise ValueError(
                    f"supervisor chaos {spec!r}: regain-host takes no arg"
                )
            chaos["regain_host_at"] = at
        elif kind == "preempt-storm":
            if arg:
                raise ValueError(
                    f"supervisor chaos {spec!r}: preempt-storm takes no arg"
                )
            chaos["preempt_storm_until"] = at
    return chaos


# ---------------------------------------------------------------------------
# Child argv surgery
# ---------------------------------------------------------------------------


def _flag_value(cmd: Sequence[str], flag: str) -> Optional[str]:
    for i, tok in enumerate(cmd):
        if tok == flag and i + 1 < len(cmd):
            return cmd[i + 1]
        if tok.startswith(flag + "="):
            return tok.split("=", 1)[1]
    return None


def _drop_flag(cmd: Sequence[str], flag: str) -> List[str]:
    """Drop ``flag`` (and its value, when the next token is not another
    flag) — the with_retries.sh drop-on-retry semantics, verbatim."""
    out: List[str] = []
    skip_next = False
    for tok in cmd:
        if skip_next:
            skip_next = False
            continue
        if tok == flag:
            skip_next = True
            continue
        if tok.startswith(flag + "="):
            continue
        out.append(tok)
    return out


def set_launcher_nproc(cmd: Sequence[str], nproc: int) -> List[str]:
    """Rewrite ``runtime.launch``'s ``--nproc`` when ``cmd`` runs the
    launcher (only its own flags, before its ``--``); other commands are
    returned unchanged."""
    cmd = list(cmd)
    if LAUNCH_MODULE not in cmd:
        return cmd
    start = cmd.index(LAUNCH_MODULE) + 1
    end = cmd.index("--", start) if "--" in cmd[start:] else len(cmd)
    head = _set_flag(cmd[start:end], NPROC_FLAG, str(nproc))
    return cmd[:start] + head + cmd[end:]


# ---------------------------------------------------------------------------
# Device inventory + geometry planning
# ---------------------------------------------------------------------------


def cpu_rank_capacity() -> int:
    """The gloo ranks this host can start for a ``--device cpu`` child: one
    per core this process may run on."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity call on this platform
        return os.cpu_count() or 1


def probe_device_count(
    timeout_sec: float = 180.0, device: Optional[str] = None,
) -> Optional[int]:
    """Available device count. For a CUDA child (``device`` None or cuda),
    ``torch.cuda.device_count()`` in a throwaway subprocess (importing
    torch in the supervisor itself would initialise CUDA before the child
    runs); for a ``--device cpu`` child, :func:`cpu_rank_capacity`.
    ``SUPERVISOR_DEVICE_COUNT`` overrides — the ops/test hook, and what a
    scheduler that already knows the inventory exports. Returns None when
    the probe fails: no information, no shrink."""
    override = os.environ.get("SUPERVISOR_DEVICE_COUNT")
    if override:
        try:
            return int(override)
        except ValueError:
            return None
    if device is not None and device.split(":")[0] == "cpu":
        return cpu_rank_capacity()
    try:
        proc = subprocess.run(
            [sys.executable, "-c",
             "import torch; print(torch.cuda.device_count())"],
            capture_output=True, text=True, timeout=timeout_sec,
        )
        if proc.returncode != 0:
            return None
        return int(proc.stdout.strip().splitlines()[-1])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def read_saved_geometry(ckpt_dir: str) -> Optional[Dict[str, Any]]:
    """The newest ``geometry_<step>.json`` sidecar's payload, or None.

    Read directly (not through a Checkpointer — no device work, no torch
    import; the port's ``runtime/checkpoint.py`` writes them): the
    supervisor only needs ``mesh_axes``/``world_size`` to
    plan a legal shrink; the elastic restore re-validates everything."""
    best_step, best_path = -1, None
    for path in glob.glob(os.path.join(ckpt_dir, "geometry_*.json")):
        m = re.search(r"geometry_(\d+)\.json$", path)
        if m and int(m.group(1)) > best_step:
            best_step, best_path = int(m.group(1)), path
    if best_path is None:
        return None
    try:
        with open(best_path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    if int(payload.get("schema_version", 0)) > 1:
        return None  # newer schema: do not guess
    if not isinstance(payload.get("mesh_axes"), dict):
        return None
    return payload


def plan_world_size(
    *,
    saved_axes: Dict[str, int],
    available: Optional[int],
    original_world: int,
    current_world: int,
) -> Optional[int]:
    """The world size the next resume attempt should run at.

    The data axis is the only elastic one: model/seq/pipe/expert
    parallelism is baked into the compiled program's sharding and the
    checkpoint layout, so the footprint ``fixed = prod(non-data axes)``
    is a hard floor. Shrinks pick the largest divisor of the SAVED data
    degree that fits (divisor-legality is what keeps the global batch an
    integer multiple of the new dp — the elastic-resume contract);
    when capacity covers the original geometry again the plan regrows
    to it. Returns None when even ``fixed`` does not fit (give up:
    there is no legal geometry), and ``current_world`` when the probe
    returned no information.
    """
    if available is None:
        return current_world
    fixed = 1
    for axis, extent in saved_axes.items():
        if axis != "data":
            fixed *= max(int(extent), 1)
    dp_saved = max(int(saved_axes.get("data", 1)), 1)
    if available >= original_world:
        return original_world
    dp_cap = available // fixed
    if dp_cap < 1:
        return None
    for d in range(min(dp_cap, dp_saved), 0, -1):
        if dp_saved % d == 0:
            return fixed * d
    return None


# ---------------------------------------------------------------------------
# Ledger
# ---------------------------------------------------------------------------


def _atomic_write_json(path: str, payload: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def new_ledger(cmd: Sequence[str], policy_source: str) -> Dict[str, Any]:
    return {
        "schema_version": SUPERVISION_SCHEMA_VERSION,
        "cmd": list(cmd),
        "policy_source": policy_source,
        "attempts": [],
        "n_attempts": 0,
        "final_class": None,
        "gave_up": False,
        "shrink_legs": [],
    }


def supervision_summary(ledger: Dict[str, Any]) -> Dict[str, Any]:
    """The compact recovery history stamped onto the final result row
    (the ledger itself stays beside the results for forensics)."""
    attempts = ledger["attempts"]
    return {
        "schema_version": SUPERVISION_SCHEMA_VERSION,
        "n_attempts": ledger["n_attempts"],
        "classes": [a["class"] for a in attempts],
        "actions": [a["action"] for a in attempts if a.get("action")],
        "shrink_legs": list(ledger["shrink_legs"]),
        "gave_up": bool(ledger["gave_up"]),
    }


def stamp_result_row(results_dir: str, started_unix: float,
                     summary: Dict[str, Any]) -> Optional[str]:
    """Attach the supervision summary to the result row the supervised
    run published (the newest ``result_*.json`` written since the
    supervisor started). Atomic rewrite; returns the stamped path."""
    newest, newest_mtime = None, started_unix
    for path in glob.glob(os.path.join(results_dir, "result_*.json")):
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            continue
        if mtime >= newest_mtime:
            newest, newest_mtime = path, mtime
    if newest is None:
        return None
    try:
        with open(newest) as f:
            row = json.load(f)
    except (OSError, ValueError):
        return None
    row["supervision"] = summary
    _atomic_write_json(newest, row)
    return newest


# ---------------------------------------------------------------------------
# The supervisor loop
# ---------------------------------------------------------------------------


class Supervisor:
    """Run one arm under the classify -> decide -> recover loop.

    ``probe`` is injectable for tests (defaults to
    :func:`probe_device_count` for the child's ``--device``); everything
    else is plain state so the decision half is unit-testable without
    ever spawning a child.
    """

    def __init__(
        self,
        cmd: Sequence[str],
        *,
        policy: Dict[str, Any],
        policy_source: str = "env",
        resume_flag: Optional[str] = None,
        drop_on_retry: Optional[str] = None,
        results_dir: Optional[str] = None,
        ledger_path: Optional[str] = None,
        chaos: Optional[Dict[str, Any]] = None,
        probe=None,
        sleep=time.sleep,
    ):
        self.cmd = list(cmd)
        self.policy = policy
        self.resume_flag = resume_flag
        self.drop_on_retry = drop_on_retry
        self.chaos = dict(chaos or {})
        device = _flag_value(cmd, "--device")
        self.probe = probe or (lambda: probe_device_count(device=device))
        self.sleep = sleep
        self.results_dir = (
            results_dir or _flag_value(cmd, "--results-dir") or "."
        )
        self.ckpt_dir = _flag_value(cmd, "--checkpoint-dir")
        ws = _flag_value(cmd, "--world-size")
        self.original_world = int(ws) if ws else None
        self.current_world = self.original_world
        self.ledger_path = ledger_path or os.path.join(
            self.results_dir, LEDGER_NAME
        )
        self.ledger = new_ledger(self.cmd, policy_source)
        self.started_unix = time.time()
        #: Per-class recoveries spent (the bounded budgets).
        self.spent: Dict[str, int] = {}

    # -- decision half (pure) -------------------------------------------

    def decide(self, exit_class: str) -> Tuple[str, str]:
        """-> (action, reason). ``give-up`` when the class has no policy
        entry, its budget is exhausted, or it is terminal by nature."""
        if exit_class == "nothing-to-resume":
            return "give-up", "deterministic refusal (exit 77) — every " \
                              "retry would refuse identically"
        spec = self.policy["classes"].get(exit_class)
        if spec is None:
            return "give-up", f"no policy entry for class {exit_class!r}"
        budget = int(spec.get("max_attempts", 0))
        used = self.spent.get(exit_class, 0)
        if used >= budget:
            return "give-up", (
                f"class {exit_class!r} budget exhausted "
                f"({used}/{budget} recoveries spent)"
            )
        return spec["action"], f"policy: {exit_class} -> {spec['action']}"

    def plan_next_cmd(self, action: str, attempt: int) -> Tuple[List[str], Dict[str, Any]]:
        """Build the next attempt's argv for ``action``; returns
        (argv, decision-notes for the ledger)."""
        notes: Dict[str, Any] = {}
        cmd = list(self.cmd)
        storm_until = self.chaos.get("preempt_storm_until", 0)
        keep_fault = attempt <= storm_until
        if self.drop_on_retry and not keep_fault:
            cmd = _drop_flag(cmd, self.drop_on_retry)
        if keep_fault:
            notes["fault_kept"] = True
        if action == "cold-retry":
            # Cold restart: the original argv minus the fault — no resume
            # flag, no geometry surgery. The harness cold-starts.
            return cmd, notes
        if self.resume_flag and self.resume_flag not in cmd:
            cmd.append(self.resume_flag)
        if action == "resume-shrunk":
            cmd, shrink_notes = self._apply_geometry(cmd, attempt)
            notes.update(shrink_notes)
        return cmd, notes

    def _probe_available(self, attempt: int) -> Optional[int]:
        lose_at = self.chaos.get("lose_host_at")
        regain_at = self.chaos.get("regain_host_at")
        capped = (
            lose_at is not None and attempt >= lose_at
            and (regain_at is None or attempt < regain_at)
        )
        if capped:
            n = self.chaos.get("lose_host_devices")
            if n is None:
                n = max((self.original_world or 2) // 2, 1)
            return int(n)
        return self.probe()

    def _apply_geometry(self, cmd: List[str], attempt: int) -> Tuple[List[str], Dict[str, Any]]:
        """The shrink/regrow half of ``resume-shrunk``: probe inventory,
        plan against the saved geometry, rewrite ``--world-size`` (and the
        launcher's ``--nproc``: the port's world is its process count)."""
        notes: Dict[str, Any] = {}
        if self.original_world is None or self.ckpt_dir is None:
            return cmd, notes  # no geometry surface to operate on
        geom = read_saved_geometry(self.ckpt_dir)
        available = self._probe_available(attempt)
        notes["devices_available"] = available
        if geom is None:
            # No sidecar (no checkpoint committed yet): a plain resume
            # degrades to a cold start inside the harness; nothing to
            # shrink against.
            return cmd, notes
        planned = plan_world_size(
            saved_axes=geom["mesh_axes"],
            available=available,
            original_world=self.original_world,
            current_world=self.current_world or self.original_world,
        )
        if planned is None:
            notes["geometry_infeasible"] = True
            return cmd, notes
        if planned != (self.current_world or self.original_world):
            leg = f"{self.current_world}->{planned}"
            notes["shrink_leg"] = leg
            self.ledger["shrink_legs"].append(leg)
            print(
                f"supervisor: capacity {available} cannot hold world size "
                f"{self.current_world} — resuming at {planned} "
                f"(geometry leg {leg})" if planned < self.current_world
                else f"supervisor: capacity returned ({available}) — "
                     f"regrowing world size {self.current_world} -> {planned}",
                file=sys.stderr,
            )
            self.current_world = planned
        cmd = _set_flag(cmd, "--world-size", str(self.current_world))
        cmd = set_launcher_nproc(cmd, self.current_world)
        return cmd, notes

    # -- mechanism half -------------------------------------------------

    def _run_attempt(self, cmd: List[str], attempt: int) -> int:
        env = dict(os.environ)
        env["BENCH_SUPERVISED_ATTEMPT"] = str(attempt)
        storm_until = self.chaos.get("preempt_storm_until", 0)
        if attempt > 1 and attempt > storm_until:
            # The env fallback for --inject-fault: one fault, one firing.
            env["INJECT_FAULT"] = ""
        proc = subprocess.Popen(cmd, env=env)

        def _forward(signum, frame):
            try:
                proc.send_signal(signal.SIGTERM)
            except (ProcessLookupError, OSError):
                pass

        prev = signal.signal(signal.SIGTERM, _forward)
        try:
            rc = proc.wait()
        finally:
            signal.signal(signal.SIGTERM, prev)
        return rc

    def _write_ledger(self) -> None:
        try:
            os.makedirs(os.path.dirname(self.ledger_path) or ".",
                        exist_ok=True)
            _atomic_write_json(self.ledger_path, self.ledger)
        except OSError as e:
            print(f"supervisor: WARNING: could not write ledger "
                  f"{self.ledger_path}: {e}", file=sys.stderr)

    def run(self) -> int:
        """The loop. Returns the exit code the supervisor should exit
        with (the final child's real code — a run that stays broken
        still fails the suite with its true classification)."""
        attempt = 0
        cmd = list(self.cmd)
        rc = 0
        while True:
            attempt += 1
            t0 = time.time()
            rc = self._run_attempt(cmd, attempt)
            if rc < 0:
                rc = 128 - rc  # signal death -> shell convention (143, 137…)
            exit_class = classify_exit(rc)
            entry: Dict[str, Any] = {
                "attempt": attempt,
                "cmd": list(cmd),
                "rc": rc,
                "class": exit_class,
                "world_size": self.current_world,
                "duration_sec": round(time.time() - t0, 3),
                "action": None,
                "backoff_sec": 0.0,
            }
            self.ledger["attempts"].append(entry)
            self.ledger["n_attempts"] = attempt
            self.ledger["final_class"] = exit_class
            if exit_class == "ok":
                self._write_ledger()
                if attempt > 1:
                    stamped = stamp_result_row(
                        self.results_dir, self.started_unix,
                        supervision_summary(self.ledger),
                    )
                    if stamped:
                        print(f"supervisor: recovery history stamped onto "
                              f"{stamped}", file=sys.stderr)
                return 0
            action, reason = self.decide(exit_class)
            entry["action"] = action
            if action == "give-up":
                self.ledger["gave_up"] = True
                entry["give_up_reason"] = reason
                self._write_ledger()
                print(f"supervisor: giving up after attempt {attempt} "
                      f"[{_describe(exit_class, rc)}]: {reason}",
                      file=sys.stderr)
                return rc
            n_spent = self.spent.get(exit_class, 0)
            self.spent[exit_class] = n_spent + 1
            wait = backoff_sec(
                self.policy, n_recoveries=n_spent,
                token=f"{os.path.basename(cmd[0])}|{attempt}",
            )
            entry["backoff_sec"] = round(wait, 3)
            next_cmd, notes = self.plan_next_cmd(action, attempt + 1)
            entry.update(notes)
            self._write_ledger()
            budget = int(self.policy["classes"][exit_class]["max_attempts"])
            left = budget - self.spent[exit_class]
            print(
                f"supervisor: attempt {attempt} failed "
                f"[{_describe(exit_class, rc)}]; action={action}"
                f"{' with ' + self.resume_flag if self.resume_flag and action != 'cold-retry' else ''}"
                f" in {wait:g}s ({left} retr{'y' if left == 1 else 'ies'} "
                f"left for this class)",
                file=sys.stderr,
            )
            if wait > 0:
                # A SIGTERM landing between attempts has no child to
                # grace: exit 143 immediately (the old backoff-trap).
                prev = signal.signal(
                    signal.SIGTERM, lambda *_: sys.exit(143)
                )
                try:
                    self.sleep(wait)
                finally:
                    signal.signal(signal.SIGTERM, prev)
            cmd = next_cmd


def _describe(exit_class: str, rc: int) -> str:
    if exit_class == "preempted":
        return f"preempted (exit={rc})"
    if exit_class == "hung":
        return f"hung (exit={rc}, watchdog abort)"
    if exit_class == "data_stall":
        return f"data stall (exit={rc})"
    return f"exit={rc}"


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

USAGE = (
    "usage: python -m distributed_llm_training_benchmark_framework_tpu_torch"
    ".runtime.supervisor [--policy FILE] [--resume-flag FLAG] "
    "[--drop-on-retry FLAG] [--results-dir DIR] [--ledger PATH] "
    "[--chaos SPEC]... -- cmd args..."
)

#: Wrapper flags that take a value. Hand-rolled (NOT argparse): the
#: values are themselves flag-shaped (``--resume-flag --resume`` is the
#: canonical call — the with_retries.sh contract), which argparse's
#: option-lookahead refuses to accept as a value.
_VALUE_FLAGS = (
    "--policy", "--resume-flag", "--drop-on-retry", "--results-dir",
    "--ledger", "--chaos",
)


def parse_cli(argv: Sequence[str]) -> Tuple[Dict[str, Any], List[str]]:
    """-> (options, child cmd). Raises ValueError on a malformed call
    (unknown flag, missing value, no ``--`` separator / no command) —
    main() maps it to the usage-error exit, matching the old wrapper."""
    opts: Dict[str, Any] = {"chaos": []}
    i = 0
    argv = list(argv)
    while i < len(argv):
        tok = argv[i]
        if tok == "--":
            cmd = argv[i + 1:]
            if not cmd:
                raise ValueError("no command after --")
            return opts, cmd
        flag, eq, inline = tok.partition("=")
        if flag in _VALUE_FLAGS:
            if eq:
                value = inline
                i += 1
            else:
                if i + 1 >= len(argv):
                    raise ValueError(f"{flag} needs a value")
                value = argv[i + 1]
                i += 2
            if flag == "--chaos":
                opts["chaos"].append(value)
            else:
                opts[flag.lstrip("-").replace("-", "_")] = value
        else:
            raise ValueError(f"unknown flag {tok}")
    raise ValueError("missing -- separator before the command")


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    try:
        opts, cmd = parse_cli(argv)
    except ValueError as e:
        print(f"supervisor: {e}\n{USAGE}", file=sys.stderr)
        return 2
    policy_path = (
        opts.get("policy") or os.environ.get("RECOVERY_POLICY") or None
    )
    try:
        policy, source = load_policy(policy_path)
        chaos_specs = list(opts["chaos"])
        env_chaos = os.environ.get("SUPERVISOR_CHAOS", "")
        chaos_specs.extend(s for s in env_chaos.split(",") if s.strip())
        chaos = parse_supervisor_chaos(chaos_specs)
    except (PolicyError, ValueError, OSError) as e:
        print(f"supervisor: {e}", file=sys.stderr)
        return 2
    sup = Supervisor(
        cmd,
        policy=policy,
        policy_source=source,
        resume_flag=opts.get("resume_flag"),
        drop_on_retry=opts.get("drop_on_retry"),
        results_dir=opts.get("results_dir"),
        ledger_path=opts.get("ledger"),
        chaos=chaos,
    )
    return sup.run()


if __name__ == "__main__":
    sys.exit(main())
