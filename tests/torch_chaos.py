"""Helpers of the port's chaos-suite tests: run ``scripts/torch_chaos_suite.sh``
on the CPU and read its outcome lines, and read the outcome lines of the JAX
side's ``scripts/chaos_suite.sh``."""

import os
import re
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
CHAOS = os.path.join(SCRIPTS, "torch_chaos_suite.sh")


def chaos_env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for var in ("INJECT_FAULT", "CHAOS_ON_DEVICE", "RECOVERY_POLICY", "SUPERVISOR_CHAOS",
                "SUPERVISOR_DEVICE_COUNT", "BENCH_SUPERVISED_ATTEMPT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "PYTHON_BIN"):
        env.pop(var, None)
    return dict(env, **extra)


def run_chaos(args, root, timeout=600, **env):
    return subprocess.run(["bash", CHAOS, *args, "--results-dir", str(root), "--keep"],
                          cwd=REPO, env=chaos_env(**env), capture_output=True, text=True,
                          timeout=timeout)


def ok_lines(out):
    """{fault: its CHAOS OK message}."""
    return dict(re.findall(r"^CHAOS OK +(\S+): (.*)$", out, re.M))


def jax_ok_lines():
    """{fault: the message JAX's suite prints on the fault's honest outcome}."""
    text = open(os.path.join(SCRIPTS, "chaos_suite.sh")).read()
    preamble, *arms = re.split(r"\n    (?=[\w|-]+\)\n)", text)
    # An arm that resumes reports through check_recovered's own line.
    (recovered,) = re.findall(r'ok "\$fault" "([^"]*)"', preamble)
    out = {}
    for arm in arms:
        head = arm.split(")", 1)[0].strip()
        msgs = re.findall(r'ok "\$fault" "([^"]*)"', arm)
        if not msgs and "check_recovered" in arm:
            msgs = [recovered]
        for fault in head.split("|"):
            if msgs:
                out[fault] = msgs[-1]
    return out
