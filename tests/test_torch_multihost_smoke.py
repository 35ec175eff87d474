"""tools/port_multihost_smoke.py on the CPU: two processes brought up
with the port's `init_multihost` against a localhost rendezvous run the
distributed BA across the process boundary, each holding it to the
single-device solver; the parent's record has the keys of the JAX
tool's record, MULTIHOST_r04.json."""

import json
import os
import subprocess
import sys

from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "port_multihost_smoke.py")


def test_two_process_distributed_ba():
    proc = subprocess.run([sys.executable, TOOL, "--device", "cpu"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(os.path.join(REPO, "MULTIHOST_r04.json")) as f:
        want = json.load(f)
    assert set(want) <= set(out)
    assert out["ok"] and out["processes"] == 2
    assert out["global_devices"] == 2
    assert sorted(c["child"] for c in out["children"]) == [0, 1]
    for child in out["children"]:
        assert set(want["children"][0]) <= set(child)
        assert child["backend"] == "gloo"
        assert child["mesh"] == {"batch": 1, "lm": 2}
        assert child["ba_parity_terr"] < 5e-3
    costs = {c["ba_cost"] for c in out["children"]}
    assert len(costs) == 1
