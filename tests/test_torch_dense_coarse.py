"""The port's dense coarse pass (``coarse_rasterize(output="dense")``,
piet_tpu_torch/ops/coarse.py) on the seven configurations of
tests/test_coarse.py, against the JAX package's dense pass word for word
and the port's ``cpu_tile_scene`` on every live prefix (the comparison of
tests/test_torch_dense.py, in a file of its own: the seven eager JAX
passes take about a minute).
"""

import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

pytest.importorskip("jax")

import numpy as np  # noqa: E402

from piet_tpu_torch.config import RenderConfig  # noqa: E402
from test_coarse import CASES  # noqa: E402
from test_torch_dense import (GROUP_SCENES, assert_dense_matches,  # noqa: E402
                              dense_both)
import test_torch_dense_tail as tail_tests  # noqa: E402


@pytest.mark.parametrize("name,make,cfg_kw", CASES,
                         ids=[c[0] for c in CASES])
def test_dense_coarse_matches_jax_and_oracle(name, make, cfg_kw):
    scene = make()
    cfg = RenderConfig(**cfg_kw)
    want, got = dense_both(scene, cfg)
    assert int(got.counts.sum()) > 0
    assert_dense_matches(want, got, scene, cfg, name)


def test_dense_tail_cases_mirror_these():
    """tests/test_torch_dense_tail.py, which runs without JAX, holds the
    kernel and the facts it rests on to the same configurations and
    scenes: CASES' names, configurations and scene arrays, and the group
    scenes of tests/test_torch_dense.py."""
    ours = tail_tests.COARSE_CASES
    assert [(n, kw) for n, _, kw in ours] == [(n, kw) for n, _, kw in CASES]
    for (name, make, _), (_, jax_make, _) in zip(ours, CASES):
        got, want = make(), jax_make()
        for field in ("tags", "colors", "widths", "bboxes", "pt_offset",
                      "n_pts", "points", "flags", "clips", "grads"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field),
                                          err_msg=f"{name}: {field}")
    assert tail_tests.GROUP_SCENES == GROUP_SCENES
