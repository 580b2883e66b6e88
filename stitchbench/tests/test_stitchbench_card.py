"""A cell on the card, briefly: decided inside a fixture, skipped without
a card. On the card's machine: `python3 -m pytest --noconftest
stitchbench/tests/test_stitchbench_card.py -q`."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from stitchbench import harness


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card")


@pytest.mark.parametrize("trace", [0, 1])
def test_pair_cell_on_the_card(card, trace):
    p = subprocess.run(
        [sys.executable, "stitchbench/run.py", "--workload",
         "default_1080p.pair_closed1", "--seed", str(2**31 + 101),
         "--seconds", "3", "--trace", str(trace)], cwd=harness.ROOT,
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
