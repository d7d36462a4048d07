"""On a card: one short run of each kind through the command the driver
runs, which has to print a correct result line (skips without a card)."""

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("workload", ["1d_edm.generate", "1d_edm.train"])
def test_short_run_is_correct(card, workload):
    done = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                           "--seed", str(2**31 + 77), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert done.returncode == 0, done.stderr[-4000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu", out
    assert list(out)[-1] == "checks"
