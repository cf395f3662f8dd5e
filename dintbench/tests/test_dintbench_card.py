"""On a card: each single-card cell's path at its tiny size through the
port's CUDA kernels, held to the plain reference (run on the card with
``python -m pytest -m cuda dintbench/tests``). It skips without one."""
from __future__ import annotations

import pytest

from dintbench import run as bench_run
from dintbench.tests.tiny import make_root


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tatp-7m.closed-w128k",
                                  "smallbank-24m.closed-w64k"])
def test_tiny_cell_on_the_card_is_correct(tmp_path, cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on one")
    args = bench_run.parse(["--workload", cell, "--seed", "123", "--seconds",
                            "1", "--trace", "1"])
    out = bench_run.run(args, make_root(tmp_path))["result"]
    assert out["correct"] is True
    assert out["device"]["busy_s"] > 0
