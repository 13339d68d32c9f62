"""The keyed and expand engines as the redesigned kernels run them.

- ``keyed.record_keyed_sums``, both of the coarse pass's keyed sums in one
  call on kernel B's records: its plain version (what a CPU tensor runs)
  against JAX's ``keyed_sum`` called as ``piet_tpu/ops/coarse.py::ksum``
  calls it (the Pallas kernel in interpret mode with the window bounds
  the JAX pass derives, and ``keyed_sum_xla``), bitwise, on kernel B's own
  records from the tiger and from the animated fixture and on synthetic
  records (keys out of range, -0.0 values, live counts 0, 1, cap and past
  cap).
- ``csrc/expand.cu``'s block schedule emulated on the CPU -- blocks of
  ``BLOCK`` slots, the one-warp 32-way search for the owners of a block's
  first and last live slot, each slot's binary search within that span,
  shared-memory staging of ``STAGE_WORDS`` words and 16-byte aligned
  stores -- against ``expand_rows_plain`` and JAX's ``expand_rows_xla``,
  bitwise.

The kernels themselves are held against the plain versions on the card
(tests/test_torch_kernels.py, chip_smoke.py).
"""

import re

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from piet_tpu.ops import expand as jexpand  # noqa: E402
from piet_tpu.ops import keyed as jkeyed  # noqa: E402
from piet_tpu_torch import kernels, tracing  # noqa: E402
from piet_tpu_torch.config import RenderConfig  # noqa: E402
from piet_tpu_torch.ops import coarse, expand, keyed  # noqa: E402
from piet_tpu_torch.ops.hitfuse import (K_CAND, K_CEND,  # noqa: E402
                                        K_CEXCL, K_DCAND, K_DVAL, K_NCMDS)
from piet_tpu_torch.renderer.capacity import fit_capacities  # noqa: E402
from piet_tpu_torch.renderer.renderer import prepare_scene  # noqa: E402
from piet_tpu_torch.scene import animate  # noqa: E402
from piet_tpu_torch.scene.svg import make_tiger  # noqa: E402
from _engine_cases import (EXPAND_CASES, EXPAND_WORDS,  # noqa: E402
                           KEYED_SYNTH, expand_rows_case,
                           keyed_synth_case, warp_search)


def _u32(x):
    return np.ascontiguousarray(np.asarray(x)).view(np.uint32)


def _coarse_kw(cfg):
    return dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                tile_w=cfg.tile_width, tile_h=cfg.tile_height,
                max_segments=cfg.max_segments, max_hits=cfg.max_hits,
                max_candidates=cfg.max_candidates)


# ---- keyed: both sums in one call ---------------------------------------

def _jax_record_sums(rec, n_live, n_out, impl):
    """The JAX pass's two keyed sums over hit records
    (piet_tpu/ops/coarse.py:617-639, 810-814), through ``ksum``'s two
    engines: the Pallas kernel in interpret mode, or the XLA segment sum."""
    rec = jnp.asarray(rec)
    hit_valid = jnp.arange(rec.shape[0], dtype=jnp.int32) < int(n_live[0])

    def ksum(values, keys, lo_b, hi_b):
        if impl == "pallas":
            return jkeyed.keyed_sum(values, keys, lo_b, hi_b, n_out,
                                    interpret=True)
        return jkeyed.keyed_sum_xla(values, keys, lo_b, hi_b, n_out)

    klo = jnp.where(hit_valid, rec[:, K_CEXCL].astype(jnp.int32), n_out)
    khi = jnp.where(hit_valid, rec[:, K_CEND].astype(jnp.int32), n_out + 1)
    cand_emit = ksum(rec[:, K_NCMDS][:, None],
                     rec[:, K_CAND].astype(jnp.int32), klo,
                     khi)[:, 0].astype(jnp.int32)
    d_val = rec[:, K_DVAL]
    dk = jnp.where(hit_valid & (d_val != 0.0),
                   rec[:, K_DCAND].astype(jnp.int32), n_out)
    delta = ksum(d_val[:, None], dk, klo, khi)[:, 0]
    return np.asarray(cand_emit), np.asarray(delta)


def _tiger_keyed_taps():
    scene = make_tiger(scale=1.0)
    cfg = fit_capacities(scene, RenderConfig(width=512, height=512))
    taps = {}
    coarse.coarse_rasterize(prepare_scene(scene, cfg, "cpu"), taps=taps,
                            **_coarse_kw(cfg))
    return taps["keyed"]


def _animated_keyed_taps():
    """The animated fixture's frame at t = 0.7 on the device-animation
    path (segments derived by expand and gatherm)."""
    tmpl = animate.template_scene(size=256, n=24, seed=5)
    cfg = fit_capacities(tmpl, RenderConfig(width=256, height=256,
                                            tile_height=16, tile_width=128),
                         bucket=True)
    base = prepare_scene(tmpl, cfg, "cpu", seg_pre=False)
    params = animate.host_params(size=256, n=24, seed=5, device="cpu")
    taps = {}
    coarse.coarse_rasterize(animate.animate_device_scene(base, params, 0.7),
                            taps=taps, **_coarse_kw(cfg))
    return taps["keyed"]


KEYED_RECORDS = {
    "tiger_512": _tiger_keyed_taps,
    "animated_256": _animated_keyed_taps,
    **{f"synthetic_{k}": (lambda k=k: keyed_synth_case(k))
       for k in KEYED_SYNTH},
}


@pytest.mark.parametrize("case", sorted(KEYED_RECORDS))
def test_record_keyed_sums_match_jax(case):
    rec, n_live, n_out = KEYED_RECORDS[case]()
    assert rec.shape[1] == 24 and n_live.shape == (1,)
    tracing.reset_launches()
    emit, delta = keyed.record_keyed_sums(rec, n_live, n_out)
    assert tracing.LAUNCHES["keyed"] == 0          # the plain version
    assert emit.dtype == torch.int32 and emit.shape == (n_out,)
    assert delta.dtype == torch.float32 and delta.shape == (n_out,)
    for impl in ("pallas", "xla"):
        w_emit, w_delta = _jax_record_sums(rec.numpy(), n_live.numpy(),
                                           n_out, impl)
        np.testing.assert_array_equal(emit.numpy(), w_emit, err_msg=impl)
        np.testing.assert_array_equal(_u32(delta.numpy()), _u32(w_delta),
                                      err_msg=impl)
    # Something was summed, and no slot reads -0.0.
    if case != "synthetic_live_0":
        assert int(emit.abs().sum()) > 0
        assert float(delta.abs().sum()) > 0
    assert not bool((delta.view(torch.int32) == -2 ** 31).any())


def test_record_keyed_sums_equal_two_keyed_sums():
    """The one call gives what the generic keyed_sum gives for each sum,
    the deltas' dead entries dropped by the live count alone."""
    rec, n_live, n_out = keyed_synth_case("live_half")
    emit, delta = keyed.record_keyed_sums(rec, n_live, n_out)
    want_emit = keyed.keyed_sum(rec[:, K_NCMDS][:, None].contiguous(),
                                rec[:, K_CAND].to(torch.int32), n_out)
    live = torch.arange(rec.shape[0]) < n_live
    dk = torch.where(live, rec[:, K_DCAND].to(torch.int32), n_out)
    want_delta = keyed.keyed_sum(rec[:, K_DVAL][:, None].contiguous(), dk,
                                 n_out)
    assert torch.equal(emit, want_emit[:, 0].to(torch.int32))
    assert torch.equal(delta.view(torch.int32),
                       want_delta[:, 0].view(torch.int32))


def test_coarse_pass_taps_one_keyed_call():
    """The coarse pass hands its keyed work to one call: the tap holds the
    hit records, their live count and n_out."""
    rec, n_live, n_out = _tiger_keyed_taps()
    assert rec.dtype == torch.float32 and rec.is_contiguous()
    assert n_live.dtype == torch.int32 and isinstance(n_out, int)


# ---- expand: the kernel's block schedule on the CPU ---------------------

def _emulate_expand(rows, counts, cap, excl):
    """csrc/expand.cu on the CPU, block by block."""
    bits = np.ascontiguousarray(rows).view(np.int32)
    n_src, words = bits.shape
    incl = excl.astype(np.int64) + counts
    total = int(excl[-1]) + int(counts[-1])
    out = np.full(cap * words, 0x5A5A5A5A, np.int32)    # unwritten marker
    block, stage_words = expand.BLOCK, expand.STAGE_WORDS
    for p0 in range(0, cap, block):
        n_slot = min(block, cap - p0)
        n_words = n_slot * words
        start = p0 * words
        assert start % 4 == 0                  # 16-byte aligned span
        if p0 >= total:                         # dead block: zeros
            out[start:start + n_words] = 0
            continue
        span0, steps0 = warp_search(incl, n_src, p0)
        span1, steps1 = warp_search(incl, n_src,
                                     min(p0 + n_slot, total) - 1)
        # Each step leaves a 32nd of the range.
        assert max(steps0, steps1) <= 1 + int(np.ceil(np.log(n_src + 1)
                                                      / np.log(32)))
        p = p0 + np.arange(n_slot)
        lo = np.full(n_slot, span0)
        hi = np.full(n_slot, span1)
        while (lo < hi).any():
            act = lo < hi
            mid = (lo + hi) >> 1
            go = incl[np.minimum(mid, n_src - 1)] > p
            hi = np.where(act & go, mid, hi)
            lo = np.where(act & ~go, mid + 1, lo)
        own = np.where(p < total, np.minimum(lo, n_src - 1), -1)
        for base in range(0, n_words, stage_words):
            n = min(stage_words, n_words - base)
            assert base % 4 == 0
            j = base + np.arange(n)
            s = j // words
            o = own[s]
            stage = np.where(o >= 0, bits[np.maximum(o, 0), j - s * words], 0)
            out[start + base:start + base + n] = stage
    return out.reshape(cap, words)


def test_expand_constants_match_the_source():
    src = (kernels.CSRC / "expand.cu").read_text()
    assert re.search(rf"constexpr int BLOCK = {expand.BLOCK};", src)
    assert re.search(rf"constexpr int STAGE = {expand.STAGE_WORDS};", src)
    # A block's span is 128 x words words: 16-byte aligned for any width.
    assert expand.BLOCK % 4 == 0 and expand.STAGE_WORDS % 4 == 0


@pytest.mark.parametrize("words", EXPAND_WORDS)
@pytest.mark.parametrize("case", sorted(EXPAND_CASES))
def test_expand_block_schedule_equals_plain(case, words):
    rows, counts, cap = expand_rows_case(case, words)
    excl = (np.cumsum(counts) - counts).astype(np.int32)
    got = _emulate_expand(rows, counts, cap, excl)
    want = expand.expand_rows_plain(torch.from_numpy(rows),
                                    torch.from_numpy(counts), cap,
                                    torch.from_numpy(excl))
    np.testing.assert_array_equal(got.view(np.uint32), _u32(want.numpy()))
    want_jax = jexpand.expand_rows_xla(jnp.asarray(rows),
                                       jnp.asarray(counts), cap)
    np.testing.assert_array_equal(got.view(np.uint32), _u32(want_jax))
    total = int(counts.sum())
    if total < cap:
        assert not got[total:].any()            # dead slots: zero bits
