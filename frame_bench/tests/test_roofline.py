"""The fine roofline's count of operations and bytes, by hand."""

import numpy as np
import pytest

from frame_bench.metrics import fine_roofline as fr

LINE, FILL, STROKE, EDGE, DRAW, SOLID, WIND, CIRCLE = 3, 4, 5, 6, 7, 8, 16, 2


def _cmd(tile, tag, *words):
    a = np.zeros(12, np.float32)
    a[:len(words)] = words
    return tile, tag, a


def _ptcl(cmds, solid):
    return {"tile": np.array([c[0] for c in cmds], np.int32),
            "tag": np.array([c[1] for c in cmds], np.int32),
            "args": np.stack([c[2] for c in cmds]),
            "solid": np.array(solid, np.uint32)}


def test_count_by_hand():
    # 2 x 2 tiles of 8 x 4 pixels in a 16 x 8 viewport.  Tile 0: a line
    # and its stroke, a fill, a fill edge, a draw fill; tile 1: a solid,
    # two winds (one of backdrop 0), a circle; tile 2 bails; tile 3 has
    # no commands (its pixels are still written).
    cmds = [
        # box (1, 1)-(3, 1) widened by 0.5: X in {1, 2, 3}, Y = 1 -> 3 px.
        _cmd(0, LINE, 1.0, 1.0, 3.0, 1.0, 0.5, 0.25),
        _cmd(0, STROKE, 0.0, 1.0, 1.0, 1.0, 1.0),            # 3 px
        # x from 2 to 2: X > 1 -> 6 columns; Y in (-0.5, 2.5) -> 3 rows.
        _cmd(0, FILL, 2.0, 0.5, 2.5, 0.0, 1.0),              # 18 px
        _cmd(0, EDGE, 1.0, 1.2),                             # Y > 0.2: 24
        _cmd(0, DRAW, 1.0, 0.5, 0.5, 0.5, 1.0),              # 32 px
        _cmd(1, SOLID, 0.5, 0.5, 0.5, 1.0),                  # 32 px
        _cmd(1, WIND, 1.0),                                  # 32 px
        _cmd(1, WIND, 0.0),                                  # 0 px
        # centre (10, 2), radius 2, inscribed half side 1.414:
        # X in {9, 10, 11}, Y in {1, 2, 3} -> 9 px.
        _cmd(1, CIRCLE, 8.0, 0.0, 12.0, 4.0),
    ]
    w = fr.count(_ptcl(cmds, [0, 0, 0xFF0000FF, 0]), width=16, height=8,
                 tile_w=8, tile_h=4, tiles_x=2)
    ops = (13 * 3 + 13 * 3 + 10 * 18 + 1 * 24 + 3 * 32 + 9 * 32 + 1 * 32
           + 9 * 9)
    assert w["ops"] == ops == 779
    assert w["commands"] == 9
    assert w["pixels"] == 3 * 32
    assert w["bytes"] == 9 * 52 + 4 * 96


def test_count_stops_at_the_viewport():
    cmds = [_cmd(1, SOLID, 0.5, 0.5, 0.5, 1.0)]
    w = fr.count(_ptcl(cmds, [0, 0, 0, 0]), width=13, height=7, tile_w=8,
                 tile_h=4, tiles_x=2)
    assert w["ops"] == 9 * 5 * 4
    assert w["pixels"] == 8 * 4 + 5 * 4 + 8 * 3 + 5 * 3


@pytest.mark.parametrize("a, b, n", [(-np.inf, np.inf, 8), (2.5, 5.0, 2),
                                     (2.0, 5.0, 2), (6.5, np.inf, 1),
                                     (9.0, 20.0, 0)])
def test_span_counts_open_intervals(a, b, n):
    assert fr._span(np.array([0]), np.array([8]), np.array([a]),
                    np.array([b]))[0] == n


def test_least_time_takes_the_larger_bound():
    peaks = {"f32_ops_per_s": 33.5e12, "hbm_bytes_per_s": 3.35e12}
    assert fr.least_seconds({"ops": 335, "bytes": 1}, peaks) == 1e-11
    assert fr.least_seconds({"ops": 1, "bytes": 335}, peaks) == 1e-10
    assert fr.peaks_for("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert fr.peaks_for("cpu") is None
