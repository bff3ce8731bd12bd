"""chip_smoke.py leaves no process running: its entry stops every
descendant (orphans included, adopted as a child subreaper) and
``stop_script`` kills every process group of a script's session.

Each check runs in a child Python, so the subreaper flag and the reaping
never touch the test process."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(not Path("/proc/self/stat").exists(),
                                reason="reads the process table under /proc")


def _child(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_stop_descendants_kills_orphans_and_children():
    res = _child("""
import json, subprocess, time
import chip_smoke as c
adopted = c.adopt_orphans()
# An orphan: its shell exits at once, leaving the sleep behind it.
orphan = int(subprocess.run(["bash", "-c", "sleep 300 >/dev/null 2>&1 & echo $!"],
                            capture_output=True, text=True).stdout)
child = subprocess.Popen(["sleep", "300"])
time.sleep(0.2)
before = c.descendants(c.os.getpid())
found, alive = c.stop_descendants(timeout=10)
print(json.dumps({"adopted": adopted, "orphan": orphan, "child": child.pid,
                  "before": sorted(before), "found": found, "alive": alive,
                  "after": sorted(c.descendants(c.os.getpid()))}))
""")
    assert res["adopted"], res
    assert sorted([res["orphan"], res["child"]]) == res["before"], res
    assert len(res["found"]) == 2 and all("sleep 300" in f for f in res["found"]), res
    assert res["alive"] == [] and res["after"] == [], res
    assert not _alive(res["orphan"]) and not _alive(res["child"]), res


def test_stop_script_kills_every_group_of_the_session():
    res = _child("""
import json, subprocess, time
import chip_smoke as c
# timeout(1) moves its command into a process group of its own.
proc = subprocess.Popen(["bash", "-c", "timeout 300 sleep 300 & wait"],
                        start_new_session=True)
time.sleep(0.5)
members = sorted(p for p, row in c.process_table().items() if row[1] == proc.pid)
groups = sorted({c.os.getpgid(p) for p in members})
c.stop_script({"proc": proc})
time.sleep(0.2)
c.reap_children()
left = sorted(p for p, row in c.process_table().items()
              if row[1] == proc.pid and row[2] != "Z")
print(json.dumps({"members": members, "groups": groups, "left": left, "rc": proc.returncode}))
""")
    assert len(res["members"]) == 3 and len(res["groups"]) == 2, res
    assert res["left"] == [] and res["rc"] == -9, res
    assert not any(_alive(p) for p in res["members"]), res


def test_the_script_ends_through_the_reaper():
    src = (REPO / "chip_smoke.py").read_text()
    assert src.rstrip().endswith('if __name__ == "__main__":\n    sys.exit(run())'), src[-200:]
