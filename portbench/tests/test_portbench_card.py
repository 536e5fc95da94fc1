"""Every cell on the card, briefly: one short run each, traced, must be
correct and report every metric BENCHMARK.json lists for it. Skips without
a CUDA card (decided inside the test). Run on the card with

    python -m pytest portbench/tests/test_portbench_card.py -q -m cuda
"""

import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_of_the_cell_is_correct_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import harness

    c = harness.load_cell(cell)
    result, checks = run.run(cell, 2**31 + 1000 + trace, 2.0, trace, t_start=time.perf_counter())
    assert result["correct"], checks
    listed = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(result["metrics"]) == listed
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
