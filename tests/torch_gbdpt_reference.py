"""The G-BDPT bars of tests/test_gbdpt.py (marked slow, so the JAX
package's CPU tier never runs them), measured on both packages on the
CPU:

    JAX_PLATFORMS=cpu python tests/torch_gbdpt_reference.py

- test_gbdpt_gradients_match_fd's config (the surface box of
  tests/test_more_integrators.py at 12x12, 6 spp, max_depth 4,
  null_bounces 2, seed 2): the correlation of gx / gy with the finite
  differences of the render's own primal, over every pixel pair (the
  test's bar: above 0.35) and over the pairs that see no light straight
  from the camera (G-BDPT's gradients leave that light out);
- test_reconnect_beats_pss_variance's (1 spp, 8 passes, seed 5): the
  per-sample gx variance of the reconnection shift over the PSS shift's
  (the test's bar: below 0.9).

The JAX side runs gbdpt.render_pass.__wrapped__ eagerly on jitted pieces
(bdpt.radiance_parts, gbdpt._connect_sweep, gbdpt._edge_terms), as
tests/test_torch_bdpt.py does; a few minutes in all. Prints one JSON
object. Not a test module: chip_smoke.py's [bidir] holds the port on
the card to the JAX package's numbers printed here.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gvpm_tpu.core.config import VolPathConfig as JaxVolPathConfig  # noqa: E402
from gvpm_tpu.integrators import bdpt as jbdpt  # noqa: E402
from gvpm_tpu.integrators import gbdpt as jgbdpt  # noqa: E402
from gvpm_tpu_torch.core.config import VolPathConfig  # noqa: E402
from gvpm_tpu_torch.integrators import gbdpt  # noqa: E402
from tests.test_more_integrators import _box  # noqa: E402
from tests.test_torch_common import port_scene_from_jax  # noqa: E402

KW = dict(max_depth=4, null_bounces=2)


def _corr(a, b):
    return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


def main():
    jax.config.update("jax_threefry_partitionable", True)
    js = _box(12, 12)
    ts = port_scene_from_jax(js)
    jcfg, tcfg = JaxVolPathConfig(**KW), VolPathConfig(**KW)
    passes = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbdpt, "radiance_parts", jax.jit(
            jbdpt.radiance_parts, static_argnames=("cfg", "rand_tile")))
        mp.setattr(jgbdpt, "_connect_sweep", jax.jit(
            jgbdpt._connect_sweep, static_argnames=("cfg", "n_steps")))
        mp.setattr(jgbdpt, "_edge_terms", jax.jit(jgbdpt._edge_terms))
        for seed, shift, n in ((2, "reconnect", 6), (5, "reconnect", 8),
                               (5, "pss", 8)):
            for it in range(n):
                st = {}
                port = [a.numpy() for a in gbdpt.render_pass(
                    ts, tcfg, seed, it, shift=shift, stats=st)]
                ref = [np.asarray(a) for a in jgbdpt.render_pass.__wrapped__(
                    js, jcfg, seed, it, shift=shift)]
                passes.setdefault((seed, shift), []).append(
                    (ref, port, st["very_direct"].amax(-1).numpy() > 0))
    out = {}
    runs = passes[(2, "reconnect")]
    lit = np.any([p[2] for p in runs], axis=0)
    mx, my = ~(lit[:, 1:] | lit[:, :-1]), ~(lit[1:, :] | lit[:-1, :])
    for k, pkg in ((0, "jax"), (1, "port")):
        primal, gx, gy = (np.mean([p[k][i] for p in runs], axis=0)
                          for i in range(3))
        fx, fy = primal[:, 1:] - primal[:, :-1], primal[1:, :] - primal[:-1, :]
        var = {s: float(np.stack([p[k][1] for p in passes[(5, s)]])
                        .var(axis=0).mean()) for s in ("reconnect", "pss")}
        out[pkg] = dict(
            corr_all=[_corr(gx[:, :-1], fx), _corr(gy[:-1, :], fy)],
            corr_unlit=[_corr(gx[:, :-1][mx], fx[mx]),
                        _corr(gy[:-1, :][my], fy[my])],
            var_reconnect=var["reconnect"], var_pss=var["pss"],
            var_ratio=var["reconnect"] / var["pss"])
    out["unlit_x_pairs"] = [int(mx.sum()), int(mx.size)]
    print(json.dumps(out))


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
