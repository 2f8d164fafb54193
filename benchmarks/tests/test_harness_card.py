"""On the card, at a size a test run holds: the control (the reference one
precision step below the configuration's, in the program's place) fails
the cell's committed limits and reads well above the program.  Sound runs
of the serve and pooled cells are correct under those limits at this size;
the training numbers of a tiny model swing more than the cell's (a leaf of
64 elements averages little), so sound training is judged at the cell's own
widths, by one whole run with a short window.  The readings that set the
limits come from ``python3 -m benchmarks.control``.

    python -m pytest benchmarks/tests/test_harness_card.py -q     # skips without a card
"""

import json
import math

import pytest
import torch

from benchmarks import harness
from benchmarks.run import run_cell
from benchmarks.tests import tiny

pytestmark = pytest.mark.cuda
SEEDS = (2_500_000_001, 2_500_000_002, 2_500_000_003)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", ["webqsp.serve", "cwq.pooled", "cwq.train"])
def test_sound_runs_pass_and_the_control_fails(card, workload):
    c = tiny.cell(workload)
    lim = harness.limits(workload)
    drv = harness.driver(c["traffic"]["kind"])
    for seed in SEEDS:
        if c["traffic"]["kind"] != "train":
            out = json.loads(run_cell(c, workload, seed, 0.5, False, card, log=lambda *a, **k: None))
            assert out["correct"], out["checks"]
        st = drv.setup(c, seed, card, harness.Spans())
        drv.window(st, 0.2, harness.Spans())
        drv.finish(st)
        sound, control = drv.readings(st), drv.readings(st, control=True)
        print(workload, seed, sound, control)
        assert any(not math.isfinite(v) or v > lim[k] for k, v in control.items()), control
        assert any(control[k] > 3 * max(sound[k], 1e-6) for k in sound), (sound, control)


def test_sound_training_at_the_cells_size_is_correct(card):
    c = harness.cell(harness.load_spec(), "cwq.train")
    out = json.loads(run_cell(c, "cwq.train", SEEDS[0], 1.0, False, card, log=lambda *a, **k: None))
    print(out["checks"])
    assert out["correct"], out["checks"]
