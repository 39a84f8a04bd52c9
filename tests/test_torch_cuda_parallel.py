"""The CLI's --mesh N on CUDA with more ranks than cards: nccl needs a
card for every rank, so the launch raises before it starts a rank,
naming both counts (the CPU tests hold the same check through
parallel.mesh.check_backend).

Needs a CUDA card and skips without one. It imports no JAX:

    python -m pytest --noconftest -o addopts="" -m gpu \
        tests/test_torch_cuda_parallel.py
"""

import pytest
import torch

from gvpm_tpu_torch import cli

pytestmark = pytest.mark.gpu


def test_cli_mesh_needs_a_card_a_rank(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"{cards + 1} nccl ranks need a "
                                         f"CUDA card each and this machine "
                                         f"has {cards}"):
        cli.main(["box-medium", "-i", "sppm", "--mesh", str(cards + 1),
                  "--width", "16", "--height", "16", "--photons", "256",
                  "--passes", "1", "-o", str(tmp_path / "x")])
