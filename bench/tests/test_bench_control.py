"""The control of the comparison, on the card at each cell's own size: the
program's W4A8 verifier in the W8A8 one's place must read a widest logit
gap above the configuration's limit, while the sound run's stays below it.
Each case is one process of ``bench/run.py --control 1`` with a short
window (~2 min each).  Skips without a card."""
import json
import subprocess
import sys

import pytest

import tiny_cell
from benchkit.spec import Bench

BENCH = Bench(tiny_cell.REPO)
CELLS = [w["name"] for w in BENCH.data["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_program_passes(card, cell):
    out = subprocess.run(
        [sys.executable, str(tiny_cell.BENCH / "run.py"), "--workload", cell,
         "--seed", str(2 ** 31 + 4242), "--seconds", "10", "--trace", "0", "--control", "1"],
        capture_output=True, text=True, timeout=600, cwd=tiny_cell.REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    limit = r["checks"]["logit_gap"]["limit"]
    assert r["served_gaps"]["max"] <= limit < r["control"]["max"], r
    assert r["correct"]
