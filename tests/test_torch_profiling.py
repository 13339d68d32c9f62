"""The port's per-stage profiler (piet_tpu_torch/profiling.py) and the
coarse pass's stage probes, against the JAX package's profiler.

What this pins on the CPU is the machinery: the probes cover the JAX
stage order less the stages folded into a kernel; ``with_probes`` and
``upto`` change nothing the pass computes (the same outputs bit for bit
and the same torch calls, a prefix stopping after its stage); and
``profile_render`` returns every key of JAX's.
The numbers themselves are CPU times here, meaningless for the card.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from piet_tpu import profiling as jprof
from piet_tpu.config import RenderConfig as JConfig
from piet_tpu.renderer.capacity import fit_capacities as jfit
from piet_tpu.scene.fixtures import make_circles_rects as jcircles
from piet_tpu_torch import profiling as prof
from piet_tpu_torch.config import RenderConfig
from piet_tpu_torch.ops import coarse
from piet_tpu_torch.renderer.capacity import fit_capacities
from piet_tpu_torch.renderer.renderer import prepare_scene
from piet_tpu_torch.scene.fixtures import make_circles_rects

torch.set_num_threads(1)

CFG_KW = dict(width=256, height=256, tile_height=32, tile_width=128,
              cmd_capacity=128)


def _tiny():
    scene = make_circles_rects(n_circles=8, n_rects=8, size=256)
    return scene, fit_capacities(scene, RenderConfig(**CFG_KW))


def _kw(cfg, output):
    return dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                tile_w=cfg.tile_width, tile_h=cfg.tile_height,
                max_segments=cfg.max_segments, max_hits=cfg.max_hits,
                max_candidates=cfg.max_candidates, output=output,
                cmd_capacity=cfg.cmd_capacity)


def test_stage_order_is_jax_s():
    assert prof.STAGE_ORDER == jprof.STAGE_ORDER
    assert prof.PROFILED == jprof.STAGE_ORDER
    assert set(prof.FOLDED.values()) <= set(coarse.PROBE_STAGES)
    assert coarse.PROBE_STAGES == tuple(
        n for n in prof.PROFILED if n not in prof.FOLDED)


@pytest.mark.parametrize("output", ["entries", "dense"])
def test_probes_cover_stage_order(output):
    """The device-derived segment stage runs every stage (the host-staged
    one skips the segment stages); "runs" is the unpaired entries route's,
    "pairing" the paired one's (test_paired_probes_cover_stage_order)."""
    scene, cfg = _tiny()
    dev = prepare_scene(scene, cfg, "cpu", seg_pre=False)
    out = coarse.coarse_rasterize(dev, with_probes=True, **_kw(cfg, output))
    want = [n for n in prof.PROFILED if n not in prof.FOLDED
            and n != "pairing" and (output == "entries" or n != "runs")]
    assert list(out.diag["probes"]) == want
    for name, vals in out.diag["probes"].items():
        assert vals and all(isinstance(v, torch.Tensor) for v in vals), name
    staged = prepare_scene(scene, cfg, "cpu")
    got = coarse.coarse_rasterize(staged, with_probes=True,
                                  **_kw(cfg, output)).diag["probes"]
    assert list(got) == [n for n in want if not n.startswith("seg_")]


class _Calls(TorchFunctionMode):
    """The torch functions and tensor methods called, in order."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.names.append(getattr(func, "__name__", repr(func)))
        return func(*args, **(kwargs or {}))


def _run(fn):
    with _Calls() as calls:
        out = fn()
    return out, calls.names


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 \
        else t


@pytest.mark.parametrize("output,seg_pre", [("entries", False),
                                            ("dense", True)])
def test_probes_and_upto_change_nothing(output, seg_pre):
    """with_probes: the same outputs bit for bit and the same torch calls
    as the plain pass; upto=<stage>: the plain pass's calls up to that
    stage, and that stage's probe tensors equal the full pass's."""
    scene, cfg = _tiny()
    dev = prepare_scene(scene, cfg, "cpu", seg_pre=seg_pre)
    kw = _kw(cfg, output)
    plain, plain_calls = _run(lambda: coarse.coarse_rasterize(dev, **kw))
    probed, probed_calls = _run(lambda: coarse.coarse_rasterize(
        dev, with_probes=True, **kw))
    assert probed_calls == plain_calls
    for a, b in zip(plain[:-1], probed[:-1]):
        assert torch.equal(_bits(a), _bits(b))
    assert {k: int(v) for k, v in plain.diag.items()} == {
        k: int(v) for k, v in probed.diag.items() if k != "probes"}
    full = probed.diag["probes"]
    for name in full:
        part, calls = _run(lambda: coarse.coarse_rasterize(dev, upto=name,
                                                           **kw))
        assert list(part) == list(full)[:list(full).index(name) + 1]
        assert calls == plain_calls[:len(calls)] and calls
        for a, b in zip(part[name], full[name]):
            assert torch.equal(_bits(a), _bits(b)), name
    with pytest.raises(ValueError, match="unknown stage"):
        coarse.coarse_rasterize(dev, upto="no_such_stage", **kw)
    with pytest.raises(ValueError, match="does not run"):
        coarse.coarse_rasterize(dev, upto="pairing", **kw)


@pytest.mark.parametrize("mode", ["compact", "hole"])
def test_paired_probes_cover_stage_order(mode):
    """A paired entries pass runs "pairing" and not "runs"; a prefix up to
    "pairing" stops right after it."""
    scene, cfg = _tiny()
    dev = prepare_scene(scene, cfg, "cpu")
    kw = _kw(cfg, "entries")
    out = coarse.coarse_rasterize(dev, with_probes=True, pair=mode, **kw)
    want = [n for n in prof.PROFILED if n not in prof.FOLDED
            and n != "runs" and not n.startswith("seg_")]
    assert list(out.diag["probes"]) == want
    part = coarse.coarse_rasterize(dev, upto="pairing", pair=mode, **kw)
    assert list(part) == want[:want.index("pairing") + 1]
    assert torch.equal(part["pairing"][0],
                       out.diag["probes"]["pairing"][0])


def test_profile_render_pairing_stage(monkeypatch):
    """With PIET_PAIR set, the entries route's profile times "pairing"
    (a stage it runs) and reads "runs" as 0.0; the dense route pairs
    nothing."""
    scene, cfg = _tiny()
    monkeypatch.setenv("PIET_PAIR", "hole")
    res = prof.profile_render(scene, cfg, fine_impl="entries", reps=2,
                              device="cpu")
    assert res["runs"] == 0.0 and res["pairing"] >= 0.0
    assert list(res) == (["dispatch_floor"] + list(prof.PROFILED)
                         + ["coarse_total", "fine", "end_to_end"])
    dense = prof.profile_render(scene, cfg, fine_impl="dense", reps=2,
                                device="cpu")
    assert dense["pairing"] == dense["runs"] == 0.0


def test_upto_a_stage_the_pass_does_not_run_raises():
    scene, cfg = _tiny()
    dev = prepare_scene(scene, cfg, "cpu")
    with pytest.raises(ValueError, match="does not run"):
        coarse.coarse_rasterize(dev, upto="seg_points",
                                **_kw(cfg, "entries"))


@pytest.fixture(scope="module")
def jax_keys():
    """The keys of JAX's profile on the same scene (its xla route; its
    pallas route adds "fine" and the entries stages)."""
    scene = jcircles(n_circles=8, n_rects=8, size=256)
    cfg = jfit(scene, JConfig(**CFG_KW))
    return list(jprof.profile_render(scene, cfg, fine_impl="xla", reps=1))


@pytest.mark.parametrize("fine_impl", ["entries", "dense"])
def test_profile_render_has_jax_s_keys(fine_impl, jax_keys):
    scene, cfg = _tiny()
    res = prof.profile_render(scene, cfg, fine_impl=fine_impl, reps=2,
                              device="cpu")
    want = list(jax_keys)
    assert [k for k in res if k in want] == want
    assert list(res) == (["dispatch_floor"] + list(prof.PROFILED)
                         + ["coarse_total", "fine", "end_to_end"])
    assert all(np.isfinite(v) and v >= 0.0 for v in res.values()), res
    for name in prof.FOLDED:
        assert res[name] == 0.0
    for name in ("seg_expand", "seg_points", "seg_derive", "seg_rects"):
        assert res[name] == 0.0      # host-staged segments
    assert res["coarse_total"] > 0 and res["end_to_end"] > 0
    table = prof.format_profile(res)
    assert "(in hit_expand)" in table and "(in cand_emit)" in table
    assert "end_to_end" in table


def test_profile_render_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scene, cfg = _tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prof.profile_render(scene, cfg, reps=1)


def test_isotonic_is_jax_s():
    y = np.array([1.0, 3.0, 2.0, 2.5, 0.5, 4.0])
    np.testing.assert_array_equal(prof._isotonic(y), jprof._isotonic(y))
    assert (np.diff(prof._isotonic(y)) >= 0).all()


def test_captured_step_stages_plain_tuples():
    """The profiler's fine step takes a plain tuple of tensors; the step's
    static inputs keep its structure (named tuples, plain tuples, None)."""
    from piet_tpu_torch.renderer.graph import CapturedStep
    step = CapturedStep(lambda x: x[0] + x[1][0], "cpu")
    a, b = torch.arange(4), torch.ones(4, dtype=torch.int64)
    staged = step.stage((a, (b,), None))
    assert type(staged) is tuple and type(staged[1]) is tuple
    assert staged[2] is None and staged[0] is not a
    assert torch.equal(step(staged), a + b)
