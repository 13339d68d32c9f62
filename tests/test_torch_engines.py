"""The port's coarse-pass engines -- ``expand_rows``, ``keyed_sum`` and
``gather_monotone`` -- against the JAX package's, bitwise (tolerance 0).

On a CPU tensor each port wrapper runs its plain PyTorch version; the JAX
functions run their Pallas kernels in interpret mode, as
tests/test_expand.py, test_keyed.py and test_gatherm.py run them, and
their ``_xla`` twins.  The kernels themselves are held against the plain
versions on the card (tests/test_torch_kernels.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from piet_tpu.ops import expand as jexpand  # noqa: E402
from piet_tpu.ops import gatherm as jgatherm  # noqa: E402
from piet_tpu.ops import keyed as jkeyed  # noqa: E402
from piet_tpu_torch.ops import expand, gatherm, keyed  # noqa: E402


def _u32(x):
    return np.ascontiguousarray(np.asarray(x)).view(np.uint32)


def _special_rows(rng, n, w):
    """f32 rows holding NaN payloads, -0.0, infinities, denormals and
    integer bit patterns."""
    rows = rng.standard_normal((n, w)).astype(np.float32)
    u = rows.view(np.uint32)
    u[0, 0] = 0x80000000                 # -0.0
    u[1, 1 % w] = 0x7FC00123             # NaN with a payload
    u[2, 0] = 0xFFA00001                 # negative signalling-NaN pattern
    u[3, w - 1] = 0x00000007             # denormal / small int word
    u[4, 0] = 0x7F800000                 # +inf
    u[5, 1 % w] = 0x00800000 - 1         # largest denormal
    return rows


def _counts(rng, n, zero_every=3, hi=5):
    c = rng.integers(1, hi, n).astype(np.int32)
    c[::zero_every] = 0
    return c


EXPAND_CASES = {
    "seeded": lambda rng: (rng.standard_normal((40, 6)).astype(np.float32),
                           rng.integers(0, 7, 40).astype(np.int32), 1024),
    "zero_counts": lambda rng: (
        rng.standard_normal((25, 3)).astype(np.float32),
        np.array([0, 0, 3] + [0] * 20 + [4, 0], np.int32), 1024),
    "bit_patterns": lambda rng: (_special_rows(rng, 33, 14),
                                 _counts(rng, 33), 1024),
    "int32_rows": lambda rng: (
        rng.integers(-2 ** 31, 2 ** 31, (30, 9), dtype=np.int64)
        .astype(np.int32), _counts(rng, 30, 4, 9), 2048),
    "over_capacity": lambda rng: (
        rng.standard_normal((20, 4)).astype(np.float32),
        np.full(20, 60, np.int32), 1024),
}


@pytest.mark.parametrize("case", sorted(EXPAND_CASES))
def test_expand_rows_matches_jax(case):
    rng = np.random.default_rng(11)
    rows, counts, cap = EXPAND_CASES[case](rng)
    excl = (np.cumsum(counts) - counts).astype(np.int32)
    got = expand.expand_rows(torch.from_numpy(rows.copy()),
                             torch.from_numpy(counts), cap)
    got_ex = expand.expand_rows(torch.from_numpy(rows.copy()),
                                torch.from_numpy(counts), cap,
                                torch.from_numpy(excl))
    want = jexpand.expand_rows(jnp.asarray(rows), jnp.asarray(counts), cap,
                               interpret=True)
    want_xla = jexpand.expand_rows_xla(jnp.asarray(rows),
                                       jnp.asarray(counts), cap)
    assert got.dtype == torch.from_numpy(rows).dtype
    for w in (want, want_xla):
        np.testing.assert_array_equal(_u32(got.numpy()), _u32(w))
    np.testing.assert_array_equal(_u32(got_ex.numpy()), _u32(want))


KEYED_CASES = {
    # (values, keys, lo, hi, n_out): every key within [lo, hi), both
    # bounds nondecreasing, as the JAX kernel's window contract asks.
    "monotone_histogram": lambda rng: _sorted_keys(rng, 3000, 2048, 2),
    "deltas_pm1": lambda rng: _deltas(rng),
    "out_of_range_keys": lambda rng: _out_of_range(rng),
    "negative_zero_only": lambda rng: (
        np.full((64, 1), -0.0, np.float32), np.arange(64, dtype=np.int32),
        np.arange(64, dtype=np.int32), np.arange(64, dtype=np.int32) + 1,
        1024),
}


def _sorted_keys(rng, n_ent, n_out, width):
    keys = np.sort(rng.integers(0, n_out, n_ent)).astype(np.int32)
    values = rng.integers(0, 3, (n_ent, width)).astype(np.float32)
    return values, keys, keys, keys + 1, n_out


def _deltas(rng):
    values, keys, lo, hi, n_out = _sorted_keys(rng, 2500, 1024, 1)
    values = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), (2500, 1))
    return values, keys, lo, hi, n_out


def _out_of_range(rng):
    """Dead records keyed to n_out (the coarse pass's spare slot) and
    beyond, with their values zeroed or not."""
    values, keys, lo, hi, n_out = _sorted_keys(rng, 1500, 1024, 1)
    keys[-200:] = n_out
    lo[-200:], hi[-200:] = n_out, n_out + 1
    values[-100:] = 2.0
    return values, keys, lo, hi, n_out


@pytest.mark.parametrize("case", sorted(KEYED_CASES))
def test_keyed_sum_matches_jax(case):
    rng = np.random.default_rng(7)
    values, keys, lo, hi, n_out = KEYED_CASES[case](rng)
    got = keyed.keyed_sum(torch.from_numpy(values), torch.from_numpy(keys),
                          n_out)
    want = jkeyed.keyed_sum(jnp.asarray(values), jnp.asarray(keys),
                            jnp.asarray(lo), jnp.asarray(hi), n_out,
                            interpret=True)
    want_xla = jkeyed.keyed_sum_xla(jnp.asarray(values), jnp.asarray(keys),
                                    None, None, n_out)
    assert got.shape == (n_out, values.shape[1])
    for w in (want, want_xla):
        np.testing.assert_array_equal(_u32(got.numpy()), _u32(w))


def test_keyed_sum_negative_zero_reads_positive_zero():
    got = keyed.keyed_sum(torch.full((4, 1), -0.0),
                          torch.tensor([0, 0, 2, 5], dtype=torch.int32), 3)
    assert got.view(torch.int32).eq(0).all()


GATHER_CASES = {
    "single_stream": lambda rng: (
        np.arange(40, dtype=np.float32).reshape(20, 2) * 1.5,
        (np.array([0, 0, 1, 3, 3, 3, 7, 19], np.int32),)),
    "two_streams_points": lambda rng: _two_streams(rng),
    "bit_patterns": lambda rng: (
        _special_rows(rng, 300, 2),
        (np.sort(rng.integers(0, 300, 1500)).astype(np.int32),)),
    "csum_column": lambda rng: (
        np.cumsum(rng.integers(-1, 2, (600, 1)), axis=0).astype(np.float32),
        (np.clip(np.sort(rng.integers(-1, 600, 1024)), 0, 599)
         .astype(np.int32),)),
}


def _two_streams(rng):
    """The endpoint fetch: i0 and i0 + 1, dead slots pinned to N - 1."""
    n = 500
    pts = rng.uniform(0, 512, (n, 2)).astype(np.float32)
    i0 = np.sort(rng.integers(0, n - 1, 900)).astype(np.int32)
    i0[-100:] = n - 1
    j1 = np.minimum(i0 + 1, n - 1).astype(np.int32)
    return pts, (i0, j1)


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gather_monotone_matches_jax(case):
    rng = np.random.default_rng(3)
    rows, idxs = GATHER_CASES[case](rng)
    got = gatherm.gather_monotone(torch.from_numpy(rows),
                                  tuple(torch.from_numpy(i) for i in idxs))
    want = jgatherm.gather_monotone(
        jnp.asarray(rows), tuple(jnp.asarray(i) for i in idxs),
        interpret=True)
    want_xla = jgatherm.gather_monotone_xla(
        jnp.asarray(rows), tuple(jnp.asarray(i) for i in idxs))
    assert len(got) == len(idxs)
    for g, w, wx in zip(got, want, want_xla):
        np.testing.assert_array_equal(_u32(g.numpy()), _u32(w))
        np.testing.assert_array_equal(_u32(g.numpy()), _u32(wx))


def test_engines_raise_on_unsupported_devices():
    meta = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError):
        expand.expand_rows(meta, torch.zeros(4, dtype=torch.int32,
                                             device="meta"), 8)
    with pytest.raises(ValueError):
        gatherm.gather_monotone(torch.zeros((4, 2)), (
            torch.zeros(3, dtype=torch.int32, device="meta"),))
