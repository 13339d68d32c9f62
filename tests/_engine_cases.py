"""Inputs shared by the CPU tests of the keyed, expand, candfuse and
gatherm engines (tests/test_torch_keyed_expand.py,
tests/test_torch_candfuse_gatherm.py) and their card tests
(tests/test_torch_kernels.py).  numpy and torch only: the card's machine
has no jax."""

import types

import numpy as np
import torch

from piet_tpu_torch.ops.hitfuse import (K_CAND, K_CEND, K_CEXCL, K_DCAND,
                                        K_DVAL, K_KEY, K_NCMDS, K_TILE,
                                        OUT_WORDS)
from piet_tpu_torch.scene.scene import (TAG_CIRCLE, TAG_CLIP, TAG_FILL,
                                        TAG_LINE, TAG_POLY)


def _counts_with_zero_runs(rng):
    c = rng.integers(1, 6, 400).astype(np.int32)
    c[:10] = 0          # a run at the start
    c[100:150] = 0      # a long run in the middle
    c[200:203] = 0
    c[-20:] = 0         # and at the end
    return c


#: name -> (counts, cap); every case's rows are made by expand_rows_case.
EXPAND_CASES = {
    # Sources that own several blocks' slots, between zero counts; cap %
    # 128 == 48.
    "owners_of_many_blocks": (
        np.array([0, 300, 2, 513, 0, 0, 128, 1, 0], np.int32), 1200),
    "zero_runs": (_counts_with_zero_runs(np.random.default_rng(5)), 1101),
    "total_0": (np.zeros(37, np.int32), 300),
    "total_eq_cap": (np.array([3, 0, 250, 1, 0, 7, 123], np.int32), 384),
    "total_eq_cap_ragged": (np.array([0, 99, 1, 0, 200], np.int32), 300),
    "one_live_slot": (np.array([0] * 60 + [1] + [0] * 60, np.int32), 257),
    "over_capacity": (np.full(20, 60, np.int32), 1000),
    "one_source": (np.array([200], np.int32), 333),
    "cap_below_block": (np.array([5, 0, 40, 5], np.int32), 77),
}

#: Row widths in words: 14 is the device-animation path's item rows; a
#: block of 40-word rows is staged in two rounds (csrc/expand.cu STAGE).
EXPAND_WORDS = (1, 3, 14, 32, 40)


def expand_rows_case(name: str, words: int, seed: int = 0):
    """(rows (S, words) f32 of random bit patterns -- NaN payloads, -0.0
    and denormals among them --, counts (S,) int32, cap)."""
    counts, cap = EXPAND_CASES[name]
    rng = np.random.default_rng(seed + words)
    bits = rng.integers(-2 ** 31, 2 ** 31, (counts.shape[0], words),
                        dtype=np.int64).astype(np.int32)
    flat = bits.reshape(-1)
    for i, w in enumerate((0x7FC00123, 0x80000000, 0x00000007,
                           0xFFA00001)):
        if i < flat.shape[0]:
            flat[i * 7 % flat.shape[0]] = np.int64(w).astype(np.int32)
    return bits.view(np.float32), counts.copy(), cap


def synth_hit_records(cap: int, n_live: int, n_out: int, seed: int):
    """Kernel B's (cap, 24) f32 record layout with the words the keyed sums
    read, item-major as kernel B writes them: each live record's h_cand
    and d_cand lie in its item's candidate range [cexcl, cand_end), both
    bounds nondecreasing.  Values include -0.0; the first records key
    below 0 and the last live ones at or past n_out (a candidate
    overflow).  Dead records (at or past n_live) have kernel B's dead
    pattern, except for nonzero winding deltas keyed inside [0, n_out),
    which only the live mask drops.  Returns (rec, n_live as (1,) int32).
    """
    rng = np.random.default_rng(seed)
    rec = np.zeros((cap, OUT_WORDS), np.float32)
    n = min(n_live, cap)
    widths = rng.integers(1, 9, n)
    starts = np.sort(rng.integers(0, n_out, n)).astype(np.int64)
    n_neg, n_over = min(3, n // 4), n // 10
    starts[:n_neg] = -6 + np.arange(n_neg) * 2
    starts[n - n_over:n] = n_out + np.arange(n_over)
    starts = np.maximum.accumulate(starts)
    ends = starts + widths
    rec[:n, K_CEXCL] = starts
    rec[:n, K_CEND] = ends
    rec[:n, K_CAND] = starts + rng.integers(0, widths)
    rec[:n, K_DCAND] = starts + rng.integers(0, widths)
    rec[:n, K_NCMDS] = rng.choice(np.array([0.0, -0.0, 1.0, 2.0],
                                           np.float32), n)
    rec[:n, K_DVAL] = rng.choice(np.array([0.0, -0.0, 1.0, -1.0],
                                          np.float32), n)
    if n:   # one record in range that surely sums
        rec[n // 2, K_NCMDS], rec[n // 2, K_DVAL] = 2.0, -1.0
    rec[:, K_KEY] = rec[:, K_TILE] = np.inf
    rec[:n, K_KEY] = rec[:n, K_TILE] = 0.0
    dead = cap - n
    if dead:
        rec[n:, K_DVAL] = rng.choice(np.array([1.0, -1.0], np.float32), dead)
        rec[n:, K_DCAND] = rng.integers(0, n_out, dead)
    return rec, np.array([n_live], np.int32)


#: name -> (cap, n_live, n_out) of synth_hit_records.
KEYED_SYNTH = {
    "live_0": (2000, 0, 1024),
    "live_1": (2000, 1, 1024),
    "live_cap": (2048, 2048, 1500),
    "live_half": (3000, 1700, 2500),
    "live_past_cap": (1024, 1500, 800),
}


def keyed_synth_case(name: str, device="cpu"):
    cap, n_live, n_out = KEYED_SYNTH[name]
    rec, live = synth_hit_records(cap, n_live, n_out, seed=cap + n_live)
    return (torch.from_numpy(rec).to(device),
            torch.from_numpy(live).to(device), n_out)


def warp_search(incl, n_src, p):
    """owner_search.cuh::warp_search on the CPU: 32 probes a step, the
    first probe that exceeds p picks the next range (a ballot and ffs on
    the card).  Returns (answer, steps)."""
    lo, hi, steps = 0, n_src, 0
    lanes = np.arange(32)
    while lo < hi:
        steps += 1
        step = (hi - lo + 31) // 32
        q = lo + lanes * step
        gt = (q >= hi) | (incl[np.minimum(q, n_src - 1)] > p)
        f = int(np.argmax(gt)) if gt.any() else 32
        if f == 0:
            break
        lo = lo + (f - 1) * step + 1
        if f < 32:
            hi = min(hi, lo + step - 1)
    return lo, steps


# ---- candfuse: item rows from adversarial scenes -------------------------

_NAN_WORDS = (0x7FC00123, 0xFFA00001, 0x80000000, 0x00000007, 0x7F800000,
              0x7FFFFFFF)


def _bit_words(rng, shape):
    """Random 32-bit patterns as f32, NaN payloads, -0.0, denormals and
    inf among them."""
    w = rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(
        np.int32)
    flat = w.reshape(-1)
    for i, v in enumerate(_NAN_WORDS):
        flat[(i * 11) % flat.shape[0]] = np.int64(v).astype(np.int32)
    return w.view(np.float32)


def adversarial_scene(ni: int, n_items: int, *, seed: int,
                      flags_high: bool = False, np_: int = 64):
    """numpy leaves with the DeviceScene field names (as
    renderer.device_scene_from_numpy takes them) whose items stress kernel
    A's item rows on a 512^2 viewport: bboxes on screen, offscreen on
    every side, straddling 0 (floor division of negative coordinates),
    at +-2^30, reversed (zero-area rects) and on tile boundaries; tags 0
    and negative, items past ``n_items`` (or ``n_items`` past NI); colours,
    clips and gradients of random bit patterns (NaN payloads, -0.0,
    denormals); widths with denormals, -0.0, inf and a NaN payload.
    ``flags_high`` sets flag words with the top bit (uint32 bits that the
    rows convert as signed int32)."""
    rng = np.random.default_rng(seed)
    tags = rng.integers(1, 8, ni).astype(np.int32)
    tags[::13] = 0
    tags[5::29] = -3
    x0 = rng.integers(-100, 600, ni)
    y0 = rng.integers(-100, 600, ni)
    bb = np.stack([x0, y0, x0 + rng.integers(-20, 400, ni),
                   y0 + rng.integers(-20, 300, ni)], 1)
    special = np.array([
        [-300, 10, -5, 90],          # left of the viewport
        [600, 10, 900, 90],          # right
        [10, -400, 90, -1],          # above
        [10, 700, 90, 900],          # below
        [-1, -1, 0, 0],              # straddling 0
        [-129, -33, -128, -32],      # negative, on tile boundaries
        [128, 32, 255, 63],          # exactly one tile
        [-2 ** 30, -2 ** 30, 2 ** 30, 2 ** 30],
        [300, 300, 200, 200],        # reversed: zero area
        [0, 0, 511, 511],            # the whole viewport
        [-2 ** 31, 5, -2 ** 31 + 7, 2 ** 31 - 1],
    ])
    bb[:len(special)] = special
    bb = bb.astype(np.int64).clip(-2 ** 31, 2 ** 31 - 1).astype(np.int32)
    widths = rng.uniform(0, 12, ni).astype(np.float32)
    widths[1:6] = np.array([1e-45, -0.0, np.inf, 3e-39, 0.0], np.float32)
    widths[6:7] = np.array([0x7FC00ABC], np.int32).view(np.float32)
    flags = rng.integers(0, 128, ni).astype(np.uint32)
    if flags_high:
        flags[::7] |= np.uint32(0x80000000)
    return types.SimpleNamespace(
        tags=tags,
        colors_u32=_bit_words(rng, (ni,)).view(np.uint32),
        colors_lin=_bit_words(rng, (ni, 4)),
        widths=widths,
        bboxes=bb,
        pt_offset=rng.integers(-5, np_ + 5, ni).astype(np.int32),
        n_pts=rng.integers(0, 9, ni).astype(np.int32),
        points=rng.uniform(0, 512, (np_, 2)).astype(np.float32),
        flags=flags,
        clips=_bit_words(rng, (ni, 4)),
        grads=_bit_words(rng, (ni, 8)),
        n_items=np.int32(n_items))


#: name -> (NI, n_items, scene seed, flags_high, rect keywords): the tile
#: grid and the slab window of the item rows.
CAND_SCENES = {
    "32x128 tiles": (300, 250, 1, False, dict(
        tiles_x=4, tiles_y=16, tile_w=128, tile_h=32, row0=0)),
    "slab row0=5": (300, 300, 2, False, dict(
        tiles_x=4, tiles_y=3, tile_w=128, tile_h=32, row0=5)),
    "16x16 tiles, n_items past NI": (200, 500, 3, False, dict(
        tiles_x=32, tiles_y=32, tile_w=16, tile_h=16, row0=0)),
    "24x20 tiles, 5 prep blocks": (2500, 2400, 4, False, dict(
        tiles_x=22, tiles_y=26, tile_w=24, tile_h=20, row0=0)),
    "flags with the top bit": (1100, 1000, 5, True, dict(
        tiles_x=4, tiles_y=16, tile_w=128, tile_h=32, row0=0)),
}


def cand_scene_case(name: str):
    """(numpy leaves, rect keywords) of a CAND_SCENES case."""
    ni, n_items, seed, high, kw = CAND_SCENES[name]
    return adversarial_scene(ni, n_items, seed=seed, flags_high=high), kw


def synth_cand_pack(counts, seed: int, tiles_x: int = 6):
    """(NI, 32) int32 candidate rows for an expansion case: random bit
    patterns (NaN payloads, -0.0, denormals), with the decode's words
    consistent: 18 the item's first slot, 19-20 a rect origin, 23 its
    width (0 among them, clamped to 1 by the decode)."""
    rng = np.random.default_rng(seed)
    ni = counts.shape[0]
    pack = _bit_words(rng, (ni, 32)).view(np.int32).copy()
    excl = (np.cumsum(counts) - counts).astype(np.int32)
    pack[:, 18] = excl
    pack[:, 19] = rng.integers(0, tiles_x, ni)
    pack[:, 20] = rng.integers(0, 40, ni)
    pack[:, 23] = rng.integers(0, 7, ni)
    return pack, excl


def adversarial_sitem(seed: int, n_slots: int = 300, np_: int = 50):
    """(sitem (S, 14) int32, points (NP, 2) f32, n_segs (1,) int32) of
    the endpoint fetch's edge cases: one-point fills and clips (the wrap
    around on their only segment), poly and line items, point indices
    before and past the table, dead slots, and point words of random bit
    patterns (NaN payloads, -0.0)."""
    rng = np.random.default_rng(seed)
    n_live = n_slots - 37
    sitem = np.zeros((n_slots, 14), np.int32)
    p = 0
    while p < n_live:
        n = int(rng.integers(1, 6))
        tag = int(rng.choice([TAG_FILL, TAG_CLIP, TAG_POLY, TAG_LINE,
                              TAG_CIRCLE]))
        npts = n if tag in (TAG_FILL, TAG_CLIP) else n + 1
        row = sitem[p:p + n]
        row[:, 0] = tag
        row[:, 1] = npts
        row[:, 2] = rng.integers(-3, np_ + 3)
        row[:, 10] = p
        row[:, 12:14] = _bit_words(rng, (2,)).view(np.int32)
        row[:, 4:10] = rng.integers(0, 9, 6)
        p += n
    sitem[n_live:] = 0                      # dead rows: zero, as expand's
    pts = _bit_words(rng, (np_, 2))
    return sitem, pts, np.array([n_live], np.int32)
