"""Inputs shared by the CPU tests of the keyed and expand engines
(tests/test_torch_keyed_expand.py) and their card tests
(tests/test_torch_kernels.py).  numpy and torch only: the card's machine
has no jax."""

import numpy as np
import torch

from piet_tpu_torch.ops.hitfuse import (K_CAND, K_CEND, K_CEXCL, K_DCAND,
                                        K_DVAL, K_KEY, K_NCMDS, K_TILE,
                                        OUT_WORDS)


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
