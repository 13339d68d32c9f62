"""The port's command math (piet_tpu_torch/ops/cmd_math.py) against the
JAX package's and the numpy mirrors, bitwise, on seeded inputs.

The JAX functions run eagerly (one primitive at a time, so XLA:CPU has no
fusion to contract) with the identity as their contraction barrier.
"""

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from piet_tpu.ops import cmd_math as jcm  # noqa: E402
from piet_tpu.raster.ptcl import div_det_np, dot2_det_np  # noqa: E402
from piet_tpu.scene.color import srgb_encode_u8  # noqa: E402
from piet_tpu_torch.ops import cmd_math as tcm  # noqa: E402

F = np.float32


def _bar(x):
    return x


def _assert_bits(got, want, msg=""):
    got = np.ascontiguousarray(np.asarray(got))
    want = np.ascontiguousarray(np.asarray(want))
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.dtype.kind == "f":
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _div_cases():
    rng = np.random.default_rng(7)
    a = rng.uniform(-4096, 4096, 4096).astype(F)
    b = rng.uniform(-4096, 4096, 4096).astype(F)
    a2 = np.concatenate([a, np.ones(512, F), rng.uniform(0, 1, 512).astype(F),
                         rng.integers(-1000, 1000, 512).astype(F),
                         np.zeros(8, F)])
    b2 = np.concatenate([b, rng.uniform(1e-5, 1e5, 512).astype(F),
                         np.exp2(rng.integers(-20, 20, 512)).astype(F),
                         rng.integers(-1000, 1000, 512).astype(F),
                         np.concatenate([np.zeros(4, F), np.ones(4, F)])])
    return a2, b2


def test_div_det_matches_numpy_mirror():
    a, b = _div_cases()
    got = tcm.div_det(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(div_det_np(a, b), F)
    ok = np.isfinite(want)
    _assert_bits(got[ok], want[ok])
    np.testing.assert_array_equal(np.isnan(got[~ok]), np.isnan(want[~ok]))


def test_dot2_det_matches_numpy_mirror():
    rng = np.random.default_rng(3)
    x = rng.uniform(-4096, 4096, 4096).astype(F)
    y = rng.uniform(-4096, 4096, 4096).astype(F)
    got = tcm.dot2_det(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    _assert_bits(got, dot2_det_np(x, y))


def test_ieee_sqrt_equals_numpy_sqrt():
    rng = np.random.default_rng(11)
    # Normal range: below ~2^-100 the split squares go subnormal and the
    # residual loses the bits that rank the candidates (JAX's as well).
    x = np.concatenate([
        rng.uniform(0, 1e6, 4096), np.exp2(rng.uniform(-90, 120, 2048)),
        [0.0, 1.0, 2.0, 4.0, np.inf]]).astype(F)
    got = tcm.ieee_sqrt(torch.from_numpy(x)).numpy()
    _assert_bits(got, np.sqrt(x))


def test_sign_keeps_negative_zero_and_nan():
    x = np.array([-0.0, 0.0, np.nan, -2.5, 3.0], F)
    got = tcm.sign(torch.from_numpy(x)).numpy()
    _assert_bits(got, jnp.sign(jnp.asarray(x)))


def test_srgb_encode_and_pack_match_jax_and_numpy():
    rng = np.random.default_rng(5)
    ch = np.concatenate([rng.uniform(-0.1, 1.1, 8192),
                         np.linspace(0, 1, 4097),
                         [0.0031308, 0.00313, 0.5, 1.0, 0.0]]).astype(F)
    got = tcm.srgb_encode_u32(torch.from_numpy(ch)).numpy()
    want = np.asarray(jcm.srgb_encode_u32(jnp.asarray(ch), _bar))
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    np.testing.assert_array_equal(got, srgb_encode_u8(ch).astype(np.int32))
    r, g, b = (rng.uniform(0, 1, 1024).astype(F) for _ in range(3))
    got = tcm.pack_rgba8(*(torch.from_numpy(v) for v in (r, g, b))).numpy()
    want = np.asarray(jcm.pack_rgba8(jnp.asarray(r), jnp.asarray(g),
                                     jnp.asarray(b), _bar))
    _assert_bits(got.view(np.uint32), want)


# ---- per-pixel evaluators over a batch of tiles -------------------------

T, TH, TW = 24, 8, 16


def _grid():
    rng = np.random.default_rng(17)
    x0 = rng.integers(0, 8, T).astype(F) * F(TW)
    y0 = rng.integers(0, 8, T).astype(F) * F(TH)
    X = (x0[:, None, None] + np.arange(TW, dtype=F)[None, None, :]
         + np.zeros((T, TH, TW), F))
    Y = (y0[:, None, None] + np.arange(TH, dtype=F)[None, :, None]
         + np.zeros((T, TH, TW), F))
    return X.astype(F), Y.astype(F)


def _words(kind):
    """Seeded operand words (T, 12) shaped like the coarse pass's."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    w = np.zeros((T, 12), F)
    pos = lambda n: rng.uniform(-10, 150, n).astype(F)  # noqa: E731
    if kind == "fill":
        sx, sy, ex, ey = pos(T), pos(T), pos(T), pos(T)
        ey[:4] = sy[:4]                      # horizontal: masked out
        ex[4:8] = sx[4:8]                    # vertical: degenerate column
        m = div_det_np(ex - sx, ey - sy)
        K = div_det_np(-(ey - sy), np.abs(ex - sx))
        w[:, :5] = np.stack([sx, sy, ey, np.where(np.isfinite(m), m, 0),
                             np.where(np.isfinite(K), K, 0)], 1)
    elif kind == "line":
        sx, sy, ex, ey = pos(T), pos(T), pos(T), pos(T)
        ex[:3], ey[:3] = sx[:3], sy[:3]      # zero length: a dot
        inv = div_det_np(np.ones(T, F), dot2_det_np(ex - sx, ey - sy))
        w[:, :6] = np.stack([sx, sy, ex, ey, np.full(T, 2.0, F), inv], 1)
    elif kind == "edge":
        w[:, 0] = rng.choice([-1.0, 1.0], T)
        w[:, 1] = pos(T)
    else:
        w[:, :8] = rng.uniform(0, 1, (T, 8))
        w[:, 0] = rng.integers(-2, 3, T)      # backdrop / half width
        w[:, 5] = rng.integers(0, 2, T)       # even-odd flag
        if kind == "circle":
            c = pos(T)
            w[:, 0:4] = np.stack([c, c, c + 40, c + 30], 1)
        if kind == "grad":
            w[:, 1:4] = rng.uniform(-0.05, 0.05, (T, 3))
            w[:, 8:12] = rng.uniform(0, 1, (T, 4))
            return w
        clip = np.stack([pos(T), pos(T), pos(T) + 60, pos(T) + 60], 1)
        no_clip = rng.uniform(size=T) < 0.5
        w[:, 8:12] = np.where(no_clip[:, None],
                              np.array([-1e9, -1e9, 1e9, 1e9], F), clip)
    return w


def _state():
    rng = np.random.default_rng(23)
    r, g, b = (rng.uniform(0, 1, (T, TH, TW)).astype(F) for _ in range(3))
    df = rng.uniform(0, 40, (T, TH, TW)).astype(F)
    area = rng.uniform(-2, 2, (T, TH, TW)).astype(F)
    cov = rng.uniform(0, 1, (T, TH, TW)).astype(F)
    return (r, g, b, df, area), cov


def _run_both(kind, pick):
    """Evaluate ``pick(module, X, Y, cov)`` -> evaluator on both sides."""
    X, Y = _grid()
    w = _words(kind)
    state, cov = _state()
    jarg = lambda k: jnp.asarray(w[:, k])[:, None, None]  # noqa: E731
    targ = lambda k: torch.from_numpy(w[:, k]).view(T, 1, 1)  # noqa: E731
    jfn = pick("jax", jnp.asarray(X), jnp.asarray(Y),
               lambda: jnp.asarray(cov))
    tfn = pick("torch", torch.from_numpy(X), torch.from_numpy(Y),
               lambda: torch.from_numpy(cov))
    want = jfn(jarg, *(jnp.asarray(s) for s in state))
    got = tfn(targ, *(torch.from_numpy(s) for s in state))
    return got, want


@pytest.mark.parametrize("idx,kind", [
    (0, "circle"), (1, "line"), (2, "fill"), (3, "stroke"), (4, "edge"),
    (5, "draw_fill"), (6, "solid")])
@pytest.mark.parametrize("with_cov", [False, True])
def test_make_commands_match_jax(idx, kind, with_cov):
    def pick(side, X, Y, cov):
        c = cov if with_cov else None
        if side == "jax":
            return jcm.make_commands(X, Y, _bar, cov=c)[idx]
        return tcm.make_commands(X, Y, cov=c)[idx]

    got, want = _run_both(kind, pick)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_bits(g.numpy(), w, f"{kind} output {i}")


@pytest.mark.parametrize("radial", [False, True])
def test_grad_commands_match_jax(radial):
    def pick(side, X, Y, cov):
        if side == "jax":
            return jcm.make_grad_commands(X, Y, _bar, cov=cov)[int(radial)]
        return tcm.make_grad_commands(X, Y, cov=cov)[int(radial)]

    got, want = _run_both("grad", pick)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_bits(g.numpy(), w, f"grad output {i}")


def test_accumulation_fields_match_jax():
    X, Y = _grid()
    jX, jY = jnp.asarray(X), jnp.asarray(Y)
    tX, tY = torch.from_numpy(X), torch.from_numpy(Y)
    for kind, jf, tf in (
            ("line", lambda a: jcm.line_field_sq(a, jX, jY, _bar),
             lambda a: tcm.line_field_sq(a, tX, tY)),
            ("edge", lambda a: jcm.edge_delta(a, jY, _bar),
             lambda a: tcm.edge_delta(a, tY))):
        w = _words(kind)
        want = jf(lambda k: jnp.asarray(w[:, k])[:, None, None])
        got = tf(lambda k: torch.from_numpy(w[:, k]).view(T, 1, 1))
        _assert_bits(got.numpy(), want, kind)
    w = _words("fill")
    jm, jd = jcm.fill_delta(lambda k: jnp.asarray(w[:, k])[:, None, None],
                            jX, jY, _bar)
    tm, td = tcm.fill_delta(lambda k: torch.from_numpy(w[:, k]).view(T, 1, 1),
                            tX, tY)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _assert_bits(td.numpy(), jd, "fill delta")
    x = np.random.default_rng(2).uniform(-3, 3, 4096).astype(F)
    for eo in (0.0, 1.0):
        _assert_bits(tcm.clip_alpha(torch.from_numpy(x), torch.tensor(eo)),
                     jcm.clip_alpha(jnp.asarray(x), jnp.float32(eo), _bar))
