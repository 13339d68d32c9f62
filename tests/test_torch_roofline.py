"""The port's roofline model (piet_tpu_torch/roofline.py) against the JAX
package's (piet_tpu/roofline.py) on the same stats dicts: the same stage
keys (``vpu_ops``/``ms_vpu`` renamed ``f32_ops``/``ms_f32``), floors
that grow linearly with the live entries and record counts.  The peaks
and the work differ by design (an H100, the port's kernels), so no
absolute value is compared with JAX's; the port's constants are held
against the sources they are derived from."""

from pathlib import Path

import pytest
import torch

from piet_tpu import roofline as jroof
from piet_tpu.config import RenderConfig as JConfig
from piet_tpu_torch import roofline as roof
from piet_tpu_torch.config import RenderConfig
from piet_tpu_torch.ops import hitfuse, sort

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RENAME = {"vpu_ops": "f32_ops", "ms_vpu": "ms_f32"}

CFG_KW = dict(width=1024, height=1024, tile_height=32, tile_width=128,
              cmd_capacity=1024, max_hits=1 << 15)
STATS = {"live_entries": 50000, "bail_tiles": 10, "n_hits": 40000,
         "n_candidates": 5000, "n_deltas": 1000, "n_segments": 30000,
         "max_tile_cmds": 400}


def _renamed(keys):
    return {RENAME.get(k, k) for k in keys}


def test_frame_roofline_keys_match_jax():
    got = roof.frame_roofline(STATS, RenderConfig(**CFG_KW), coarse_ms=2.0,
                              fine_ms=3.0, total_ms=5.0)
    want = jroof.frame_roofline(STATS, JConfig(**CFG_KW), coarse_ms=2.0,
                                fine_ms=3.0, total_ms=5.0)
    assert got.keys() == want.keys() == {"fine", "coarse", "frame"}
    for stage in want:
        assert set(got[stage]) == _renamed(want[stage]), stage
        assert 0 < got[stage]["pct_of_roofline"] <= 100, stage
        assert got[stage]["ms_floor"] > 0
    # No measured time: no percent, as in JAX.
    bare = roof.frame_roofline(STATS, RenderConfig(**CFG_KW), None, None, 0)
    assert all("pct_of_roofline" not in d for d in bare.values())


def test_stage_models_keys_match_jax():
    kw = dict(tile_h=32, tile_w=128, n_tiles=256)
    assert set(roof.fine_model(STATS, **kw)) == _renamed(
        jroof.fine_model(STATS, **kw))
    ckw = dict(max_hits=1 << 15, max_candidates=1 << 10, max_deltas=1 << 10)
    assert set(roof.coarse_model(STATS, **ckw)) == _renamed(
        jroof.coarse_model(STATS, **ckw))


def _linear(model, key, values, **kw):
    """model's bytes at each of ``values`` of stats[key]: equal steps."""
    b = [model(dict(STATS, **{key: v}), **kw)["bytes_moved"]
         for v in values]
    return b[1] - b[0], b[2] - b[1]


@pytest.mark.parametrize("key,per_unit", [
    ("live_entries", roof.ENTRY_BYTES)])
def test_fine_floor_linear_in_entries(key, per_unit):
    kw = dict(tile_h=32, tile_w=128, n_tiles=256)
    d0, d1 = _linear(roof.fine_model, key, (1000, 2000, 3000), **kw)
    assert d0 == d1 == 1000 * per_unit
    j0, j1 = _linear(jroof.fine_model, key, (1000, 2000, 3000), **kw)
    assert j0 == j1 > 0
    big = roof.fine_model(dict(STATS, live_entries=100000), **kw)
    small = roof.fine_model(dict(STATS, live_entries=1000), **kw)
    assert big["ms_floor"] > small["ms_floor"] > 0


@pytest.mark.parametrize("key,per_unit", [
    ("n_hits", roof.HIT_RECORD_BYTES + 3 * roof.ENTRY_BYTES + 16),
    ("n_candidates", roof.CAND_RECORD_BYTES + 3 * roof.ENTRY_BYTES + 16),
    ("n_segments", roof.SEG_ROW_BYTES)])
def test_coarse_floor_linear_in_records(key, per_unit):
    """Each record adds its own bytes (the sort's 16 on the cluster route
    of a 2^15 + 2^10 pair sort)."""
    kw = dict(max_hits=1 << 15, max_candidates=1 << 10, max_deltas=1 << 10)
    d0, d1 = _linear(roof.coarse_model, key, (1000, 2000, 3000), **kw)
    assert d0 == d1 == 1000 * per_unit
    if key != "n_segments":  # JAX counts segments' bytes too, and records
        j0, j1 = _linear(jroof.coarse_model, key, (1000, 2000, 3000), **kw)
        assert j0 == j1 > 0


def test_fine_dense_route_counts_commands():
    kw = dict(tile_h=32, tile_w=128, n_tiles=256)
    stats = {"live_cmds": 5000, "max_tile_cmds": 100}
    m = roof.fine_model(stats, **kw)
    px = 256 * 32 * 128
    assert m["bytes_moved"] == 5000 * 13 * 4 + 256 * 4 + px * 4
    # 5000 commands at most 100 a tile: at least 50 tiles resolve.
    assert m["f32_ops"] == 50 * 32 * 128 * roof.OPS_RESOLVE


def test_sort_bytes_follow_the_plan():
    """The cluster route moves each pair once; the device-memory route
    once per digit pass, after an upsweep that reads each key."""
    small = roof.sort_bytes(100, 1 << 16, (1 << 20,))
    assert small == 100 * 16
    n = sort.CLUSTER * sort.CLUSTER_CHUNK + 1
    plan = sort.sort_plan(n, (1 << 20,))
    assert plan.cluster == 0
    assert roof.sort_bytes(100, n, (1 << 20,)) == 100 * (
        16 * len(plan.passes) + 4)


def test_peaks_and_bound():
    assert roof.HBM_BYTES_PER_S == 3.35e12
    assert roof.F32_OPS_PER_S == 33.5e12
    assert roof.bound(3.35e9) == (pytest.approx(1.0), "bytes")
    ms, by = roof.bound(0, 33.5e9)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_sort_key_bounds_packed_and_unpacked():
    """The coarse pass's key bounds, which the coarse floor's sort reads:
    packed below 2^24, else the two unpacked keys."""
    from piet_tpu_torch.ops.coarse import sort_key_bounds
    cfg = RenderConfig(width=1024, height=1024, max_items=2048,
                       tile_height=32, tile_width=128)
    assert sort_key_bounds(cfg.n_tiles, 2048) == (cfg.n_tiles * 2 * 2049,)
    unp = RenderConfig(width=1024, height=1024, max_items=2048,
                       tile_height=16, tile_width=16)
    assert sort_key_bounds(unp.n_tiles, 2048) == (unp.n_tiles, 2 * 2048 + 2)


def test_constants_match_their_sources():
    """The record sizes and the resolve's polynomial lengths are those of
    the sources the model counts."""
    assert roof.HIT_RECORD_BYTES == hitfuse.OUT_WORDS * 4
    cmd_math = (ROOT / "piet_tpu_torch" / "csrc" / "cmd_math.cuh").read_text()
    # 9 log-polynomial and 6 exp-polynomial coefficients: 8 and 5 steps
    # of a multiply and an add.
    assert "const float PL[9]" in cmd_math and "const float PE[6]" in cmd_math
    assert "for (int i = 1; i < 9; ++i) acc = (acc * m) + PL[i];" in cmd_math
    assert "for (int i = 1; i < 6; ++i) pe = (pe * fr) + PE[i];" in cmd_math
    assert roof.OPS_RESOLVE == 3 * (2 + 1 + 2 * 8 + 2 + 2 + 2 * 5 + 3 + 1)


def test_chip_smoke_takes_the_peaks_from_the_port():
    """The peaks exist once: chip_smoke.py repeats none of them and takes
    what it checks against them (frame_roofline) from the port."""
    text = (ROOT / "chip_smoke.py").read_text()
    assert "3.35e12" not in text and "67e12" not in text
    assert "from piet_tpu_torch.roofline import" in text
