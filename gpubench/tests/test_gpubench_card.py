"""Each cell run end to end by ``gpubench/run.py`` on the card, one short
window each; skipped where there is no CUDA card.  On the chip:

    python3 -m pytest gpubench/tests -m card -p no:cacheprovider \\
        --confcutdir=gpubench -o addopts=""
"""
import json
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(card, name):
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                          name, "--seed", str(2 ** 32 + 15), "--seconds",
                          "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
