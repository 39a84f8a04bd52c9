"""On the card: each one-chip cell's configuration at a smaller film and
photon count, its pass checked against the reference under the cell's
committed limits, and the control (the reference in bfloat16 in the
program's place) failing them. Needs a CUDA card and skips without one:

    python -m pytest -o addopts="" -m gpu gbench/tests/test_gbench_gpu.py
"""

import pytest
import torch

from gbench import check, harness

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _small(name):
    cell = harness.load_cell(name)
    cell["config"]["scene"].update(width=128, height=128)
    g = cell["config"]["gradient_config"]
    g.update(surface_photons=1 << 16, volume_photons=1 << 16)
    return cell


@pytest.mark.parametrize("name", ["vpm512-me", "vpm512-nome"])
def test_cell_pass_and_control(card, name):
    cell = _small(name)
    limits = cell["limits"]
    for seed in (2 ** 31 + 3, 2 ** 31 + 4, 2 ** 31 + 5):
        run = harness.Pass(cell, seed, card)
        log = []
        harness.rerun(run, 2, log)
        nums = harness.pass_numbers(run, log, 2)
        film = next(o for k, _, _, o in log if k == "film")
        nums["solve_err"] = check.solve_numbers(film, run.solve(*film),
                                                run.cfg)
        nums["repeat_err"] = 0.0
        ok, rows = check.judge(nums, limits)
        assert ok, rows
        ctl = harness.pass_numbers(run, log, 2, dtype=torch.bfloat16)
        ctl["solve_err"] = check.solve_numbers(film, None, run.cfg,
                                               torch.bfloat16)
        assert any(v > limits[k] for k, v in ctl.items()), ctl
