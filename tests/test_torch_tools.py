"""The port's tools (piet_tpu_torch/tools/) against the JAX package's
(tools/), on the CPU, where each kernel's plain version runs.

The JAX tools are loaded from their files.  Their Pallas kernels run in
interpret mode, where XLA:CPU contracts a multiply and an add into an FMA
inside the interpreted kernel (tests/_imgcmp.py).  So each comparison
with an interpreted kernel states its tolerance, and where a tool's own
op can run eagerly (one primitive at a time, nothing to contract), the
port's plain version is held to it bitwise.
"""

import ast
import functools
import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from _imgcmp import assert_images_match  # noqa: E402
from piet_tpu.ops.fine import fine_rasterize_entries as jax_fine  # noqa: E402
from piet_tpu_torch.ops import probes  # noqa: E402
from piet_tpu_torch.tools import (arg_delivery_bench, div_probe,  # noqa: E402
                                  fine_entry_bench, half_experiment,
                                  mosaic_numerics_probe)

ROOT = Path(__file__).resolve().parent.parent
F = np.float32


@functools.lru_cache(maxsize=None)
def _tool(name: str):
    """The JAX tool ``tools/<name>.py`` as a module; the environment and
    sys.path it edits at import are put back."""
    env, path = dict(os.environ), list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    return mod


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, F)).view(np.uint32)


def _assert_bits(got, want, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=msg)


def _interpret(kernel, out_shape, n_in):
    return jax.jit(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * n_in,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True))


# ---- division ------------------------------------------------------------

def test_div_plain_equals_pallas_kernel_and_numpy():
    """The plain division against the tool's kernel (interpret mode, one
    division, nothing to contract) and numpy, bitwise, on a 2^14 cut of
    the tool's operand mix."""
    tool = _tool("div_probe")
    a, b = div_probe.operands(1 << 14)
    got = probes.probe_div(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    _assert_bits(got, _interpret(tool._kernel, a.shape, 2)(a, b))
    _assert_bits(got, a / b)
    lines = div_probe.report(div_probe.compare(a, b, device="cpu"))
    assert lines == [f"{n}: IDENTICAL (0/16384 words)" for n in (
        "kernel_vs_torch", "torch_vs_numpy", "kernel_vs_numpy")]


@pytest.mark.parametrize("n", [1 << 14, 1027])
def test_div_is_the_numerics_division(n):
    """probe_div is probe_numerics' division op: on CPU tensors bitwise
    the op's plain version, numpy's quotient and the tool's kernel
    (interpret mode), on the first n words of the tool's operand mix
    (1027: a ragged length, 3 words past a multiple of 4)."""
    tool = _tool("div_probe")
    a, b = (x.reshape(-1)[:n].copy() for x in div_probe.operands(1 << 14))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    got = probes.probe_div(at, bt).numpy()
    _assert_bits(got, probes.probe_numerics_plain("div", at, bt).numpy())
    _assert_bits(got, probes.probe_numerics("div", at, bt).numpy())
    _assert_bits(got, a / b)
    _assert_bits(got, _interpret(tool._kernel, a.shape, 2)(a, b))


# ---- numerics ------------------------------------------------------------

def _contraction_bound(name, ins, want):
    """Per word, the most XLA:CPU's FMA contraction inside an interpreted
    kernel can move the op's result: a product added without its own
    rounding (<= 1/2 ulp of the product), and each later rounding then
    off by <= 1 ulp of its result.  In ulps of the op's largest term:
    3 for muladd2 and lerp; fill_delta_chain's numerator <= 4 ulps of its
    largest term (<= 1.5 or |xmin|), divided by xmax - xmin, plus 1 ulp
    of the quotient; srgb_chain <= 1 code.  0 where nothing contracts."""
    def ulp(x):
        return np.spacing(np.abs(np.asarray(x, F))).astype(np.float64)
    if name == "muladd2":
        a, b, c, d = ins
        return 3 * ulp(np.maximum(np.abs(a * b), np.abs(c * d)))
    if name == "lerp":
        r, f, w = ins
        return 3 * ulp(np.maximum(np.abs(r), np.abs((f - r) * w)))
    if name == "fill_delta_chain":
        bq, dq, cq, xmin, xmax = ins
        num = np.maximum(np.maximum(F(1.5), np.abs(xmin)),
                         np.abs(want * (xmax - xmin)))
        return 4 * ulp(num) / np.abs(xmax - xmin) + ulp(want)
    if name == "srgb_chain":
        return np.ones_like(want, np.float64)
    return np.zeros_like(want, np.float64)


@pytest.mark.parametrize("name", list(probes.NUMERICS_OPS))
def test_numerics_op_equals_tool_and_mirror(name):
    """Each op's plain version on the tool's inputs (both shapes, the
    first 4 of the 16 batches): bitwise the port's numpy mirror, the
    tool's mirror and the tool's op run eagerly; within the contraction
    bound of the tool's op in an interpret-mode pallas_call."""
    tool = _tool("mosaic_numerics_probe")
    jx, npx, mk = tool.OPS[name]()
    mirror, _ = mosaic_numerics_probe.MIRRORS[name]
    rng = np.random.default_rng(0)
    for op in tool.OPS:                   # the tool's draws, in its order
        if op == name:
            break
        for shape in tool.SHAPES:
            for _ in range(tool.N_BATCH):
                tool.OPS[op]()[2](rng, shape)
    ours = mosaic_numerics_probe.inputs()

    def kernel(*refs):                    # the tool's run_pallas kernel
        refs[-1][...] = jx(*[r[...] for r in refs[:-1]])

    for shape in tool.SHAPES:
        kern = _interpret(kernel, shape, probes.NUMERICS_OPS[name])
        for k in range(tool.N_BATCH):
            ins = mk(rng, shape)
            for x, y in zip(ins, ours[name, shape][k]):
                _assert_bits(x, y)
            if k >= 4:
                continue
            got = probes.probe_numerics(
                name, *[torch.from_numpy(x) for x in ins]).numpy()
            want = npx(*ins).astype(F)
            _assert_bits(got, want, f"{name} {shape} vs the tool's mirror")
            _assert_bits(got, mirror(*ins).astype(F), name)
            _assert_bits(got, jx(*[jnp.asarray(x) for x in ins]),
                         f"{name} {shape} vs the tool's op, eager")
            off = np.abs(np.asarray(kern(*ins), np.float64) - want)
            bound = _contraction_bound(name, ins, want)
            assert (off <= bound).all(), (name, shape, off.max())


def test_numerics_probe_reports_zero_ulp_on_the_cpu():
    lines = mosaic_numerics_probe.report(
        mosaic_numerics_probe.probe(["div", "srgb_chain"], device="cpu"))
    assert lines == [
        "div                (16, 128): mismatched 0/32768 worst_ulp=0",
        "div                (32, 128): mismatched 0/65536 worst_ulp=0",
        "srgb_chain         (16, 128): mismatched 0/32768 worst_ulp=0",
        "srgb_chain         (32, 128): mismatched 0/65536 worst_ulp=0"]


# ---- the half-state chain ----------------------------------------------

@functools.lru_cache(maxsize=None)
def _mix_kernel(n_iter: int):
    """``_mix_kernel`` of tools/half_experiment.py, taken from its source
    with ``ast`` (the module runs its experiment when imported), with
    N_ITER = n_iter."""
    tree = ast.parse((ROOT / "tools" / "half_experiment.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "_mix_kernel")
    ns = {"jax": jax, "jnp": jnp, "N_ITER": n_iter}
    exec(compile(ast.Module(body=[fn], type_ignores=[]),
                 "tools/half_experiment.py", "exec"), ns)
    return ns["_mix_kernel"]


@pytest.mark.parametrize("shape", [(16, 128), (32, 128)])
@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_halfmix_chain_equals_tool_kernel(kind, shape):
    """The chain at N_ITER = 40 against ``_mix_kernel`` in interpret
    mode, bitwise in both types.  bf16 too: each op of two bf16 operands
    rounds once to bf16 on both sides (a bf16 product is exact in f32,
    and a bf16 sum is too, or falls far from a bf16 rounding tie), the
    constants are exact in bf16, and the state never holds a zero or a
    NaN."""
    n_iter = 40
    dt = jnp.float32 if kind == "float32" else jnp.bfloat16
    kern = functools.partial(_mix_kernel(n_iter), dtype=dt, shape=shape)
    want = pl.pallas_call(
        kern, grid=(1,),
        out_specs=pl.BlockSpec(shape, lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
        scratch_shapes=[pltpu.VMEM(shape, dt)] * 3, interpret=True)()
    got = half_experiment.run(kind, shape, tiles=2, n_iter=n_iter,
                              device="cpu")
    assert got.shape == (2,) + shape
    for tile in got.numpy():
        _assert_bits(tile, want)


def test_halfmix_ops_per_step_counts_the_chain():
    """The bound's operation count is the plain chain's: the arithmetic,
    compare and select calls of one step at one element (the negation is
    an operand modifier, the constants' splats and the dtype casts are no
    operations)."""
    ops = {"mul", "add", "sub", "gt", "minimum", "maximum", "where"}
    seen = []

    class Count(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in ops:
                seen.append(func.__name__)
            return func(*args, **(kwargs or {}))

    init = probes.halfmix_init(1).narrow(2, 0, 1).contiguous()
    with Count():
        probes.probe_halfmix_plain(init, "float32", 1, 1)
    assert len(seen) == probes.HALFMIX_OPS_PER_STEP, seen


def test_halfmix_packed_state_rounds_as_bf16():
    """The packed type's plain version is the bf16 chain's: the same
    words at every element, and a state that moved (st2 < 0)."""
    a = half_experiment.run("bfloat16x2", (16, 128), 1, 24, "cpu")
    b = half_experiment.run("bfloat16", (16, 128), 1, 24, "cpu")
    _assert_bits(a.numpy(), b.numpy())
    assert float(a.max()) < 0.0


# ---- operand delivery --------------------------------------------------

#: The tool's kernels by the port's variant name: (kernel, SMEM operands,
#: extra scratch rows).
_DELIVERY = {
    "smem": ("k_smem", True, 0), "vmem": ("k_vmem", False, 0),
    "batch8": ("k_batch8", False, 0), "smem16": ("k_smem16", True, 16),
    "smem_win": ("k_smem_win", True, 16),
    "batch816": ("k_batch8_16", False, 16), "smem32": ("k_smem32", True, 32),
    "smemw32": ("k_smem_win32", True, 32), "disp16": ("k_disp16", True, 16),
}
#: Entries a test stream holds: 64, and for disp16 87, whose last entry
#: (86) is the stream's first tag-3 entry (after a tag-6 one at 52), so
#: the state ends finite: the tool's 2048 end in 178 multiplies past the
#: last tag-3 entry, and every pixel at +inf.
_N = {"disp16": 87}
REPS = 2


@functools.lru_cache(maxsize=None)
def _tool_delivery(variant, n):
    """The tool's kernel with its N and REPS patched to n and REPS, in
    interpret mode, as its ``run`` calls it; rows 0-7 of the state."""
    tool = _tool("arg_delivery_bench")
    name, smem, big = _DELIVERY[variant]
    saved = tool.N, tool.REPS
    tool.N, tool.REPS = n, REPS
    try:
        scr = [pltpu.VMEM((8, 128), jnp.float32)]
        if big:
            scr.append(pltpu.VMEM((big, 128), jnp.float32))
        f = pl.pallas_call(
            getattr(tool, name), grid=(1,),
            in_specs=[pl.BlockSpec(
                memory_space=pltpu.SMEM if smem else pltpu.VMEM)],
            out_specs=pl.BlockSpec((8, 128), lambda i: (0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
            scratch_shapes=scr, interpret=True)
        data = np.random.RandomState(0).uniform(
            0, 128, size=(n, 16)).astype(np.float32)
        x = np.ascontiguousarray(data[:, :8].T) if smem else data
        return np.asarray(f(jnp.asarray(x)))
    finally:
        tool.N, tool.REPS = saved


@pytest.mark.parametrize("tiles", [1, 3])
@pytest.mark.parametrize("variant", list(probes.DELIVERY_VARIANTS))
def test_delivery_variant_equals_tool_kernel(variant, tiles):
    """Each variant's plain version against the tool's kernel (N, REPS
    patched small) in interpret mode: rows 0-7 of every tile within
    2^-10, relative and absolute.  XLA:CPU contracts the chain's products
    into FMAs there (measured: <= 3.1e-5 absolute, 5.3e-5 relative, on
    323 of the 1,024 words at N = 64); the chain's own order is held
    bitwise against the tool's ``_chain`` run eagerly
    (test_delivery_field_equals_tool_chain).  Every tile is the one-tile
    state, bitwise, with the one-tile pass count."""
    n = _N.get(variant, 64)
    want = _tool_delivery(variant, n)
    d = arg_delivery_bench.data(n, device="cpu")
    got, passes = probes.probe_delivery(d, variant, REPS, tiles)
    one, one_passes = probes.probe_delivery(d, variant, REPS)
    rows = probes.DELIVERY_VARIANTS[variant][0]
    assert got.shape == (tiles, rows, 128) and one.shape == (1, rows, 128)
    assert passes.dtype == torch.int32 and passes.shape == (tiles,)
    assert (passes == one_passes[0]).all()
    assert int(one_passes[0]) == probes.delivery_passes(d, variant, REPS)
    assert np.isfinite(want).all()
    for tile in got.numpy():
        _assert_bits(tile, one[0].numpy())
        assert np.isfinite(tile).all()
        np.testing.assert_allclose(tile[:8], want, rtol=2 ** -10,
                                   atol=2 ** -10)


def _recount_passes(x: np.ndarray, variant: str, reps: int) -> int:
    """The tool's loop structure in numpy, counting one per (entry pass,
    row) chain update: every row of the tile (rows of 8-entry groups for
    batch8), the rows of the window (``pl.ds(rs, WH)`` where the band
    fits, else all), the tile's rows where the tag is 3."""
    rows, how = probes.DELIVERY_VARIANTS[variant]
    count = 0
    for _ in range(reps):
        if how == "batch8":
            for j in range(0, x.shape[0], 8):
                count += rows * len(x[j:j + 8])
            continue
        for e in x:
            if how == "window":
                sy, ey, thr = np.float32(e[1]), np.float32(e[3]), e[4]
                lo = np.float32(min(sy, ey) - thr)
                hi = np.float32(max(sy, ey) + thr)
                rs = min(max(int(np.floor(lo)), 0), rows - 8)
                count += 8 if int(np.ceil(hi)) - rs <= 8 else rows
            elif how == "dispatch":
                count += rows if int(e[5]) == 3 else 0
            else:
                count += rows
    return count


@pytest.mark.parametrize("variant", list(probes.DELIVERY_VARIANTS))
def test_delivery_passes_recount_the_tool_loops(variant):
    """delivery_passes, and every tile's count of the plain version,
    against a numpy recount of the tool's loops on 256 entries of a
    mixed stream, 3 passes: the windows both fit and miss there, and the
    dispatch variant takes the chain on some entries and not others."""
    d = arg_delivery_bench.mixed_data(256, "cpu")
    want = _recount_passes(d.numpy(), variant, 3)
    rows, how = probes.DELIVERY_VARIANTS[variant]
    full = 3 * 256 * rows
    if how == "window":
        assert 3 * 256 * 8 < want < full
    elif how == "dispatch":
        assert 0 < want < full
    else:
        assert want == full
    assert probes.delivery_passes(d, variant, 3) == want
    _, passes = probes.probe_delivery(d, variant, 3, tiles=2)
    assert passes.tolist() == [want, want]
    assert probes.delivery_passes(d, variant, 0) == 0


def test_delivery_field_equals_tool_chain():
    """The plain field, min-reduced over the entries, bitwise the tool's
    ``_chain`` run eagerly (one primitive at a time) over the same
    entries and a (32, 128) tile."""
    tool = _tool("arg_delivery_bench")
    d = arg_delivery_bench.data(48, device="cpu")
    x = d.numpy()
    X = jnp.broadcast_to(jnp.arange(128, dtype=jnp.float32), (32, 128))
    Y = jnp.broadcast_to(jnp.arange(32, dtype=jnp.float32)[:, None],
                         (32, 128))
    st = jnp.full((32, 128), 1e18, jnp.float32)
    for j in range(x.shape[0]):
        st = tool._chain(*(jnp.float32(v) for v in x[j, :4]), X, Y, st)
    got, _ = probes.probe_delivery(d, "smem32", 1)
    _assert_bits(got[0].numpy(), st)


def test_delivery_ops_count_the_data():
    """The bound's operation count: every pixel for the full-tile
    variants; the window's rows; the dispatch's taken branches; over
    many tiles, the tiles times the one tile's count."""
    d = arg_delivery_bench.data(64, device="cpu")
    px = probes.CHAIN_OPS_PER_PIXEL
    ent = probes.CHAIN_OPS_PER_ENTRY
    assert probes.delivery_ops(d, "smem", 3) == 3 * 64 * (8 * 128 * px + ent)
    rows = probes.window_rows(d, 16)
    assert probes.delivery_ops(d, "smem_win", 1) == (
        int(rows.sum()) * 128 * px + 64 * ent)
    tag = d[:, 5].to(torch.int32)
    n3, n6, n5 = (int((tag == 3).sum()), int((tag == 6).sum()),
                  int((tag >= 5).sum()))
    assert probes.delivery_ops(d, "disp16", 1) == (
        n3 * (16 * 128 * px + ent) + (n6 + n5) * 16 * 128)
    for v in probes.DELIVERY_VARIANTS:
        assert probes.delivery_ops(d, v, 2, tiles=676) == (
            676 * probes.delivery_ops(d, v, 2))


# ---- fine_entry_bench ----------------------------------------------------

@pytest.mark.parametrize("n", [2, 34])
@pytest.mark.parametrize("mix", fine_entry_bench.MIXES)
def test_entry_bench_stream_equals_tools(mix, n):
    """build_stream word for word against the JAX tool's (its block
    layout transposed to the port's entry-major rows)."""
    tool = _tool("fine_entry_bench")
    jf, jn, js, jstream = tool.build_stream(mix, n, np.random.RandomState(7))
    first, n_entries, solid, stream = fine_entry_bench.build_stream(
        mix, n, np.random.RandomState(7))
    np.testing.assert_array_equal(first, jf)
    np.testing.assert_array_equal(n_entries, jn)
    np.testing.assert_array_equal(solid, js.view(np.int32))
    _assert_bits(stream, np.asarray(jstream).transpose(0, 2, 1).reshape(
        -1, 16))


@pytest.mark.parametrize("mix", fine_entry_bench.MIXES)
def test_entry_bench_image_equals_jax_fine(mix):
    """Kernel D's plain version on the n = 34 stream against JAX's
    fine_rasterize_entries in interpret mode, run dispatch on, under the
    shared CPU image policy (tests/_imgcmp.py)."""
    tool = _tool("fine_entry_bench")
    jf, jn, js, jstream = tool.build_stream(mix, 34,
                                            np.random.RandomState(7))
    fb = fine_entry_bench
    want = np.asarray(jax_fine(
        jf, jn, js, jstream, tile_h=fb.TILE_H, tile_w=fb.TILE_W,
        tiles_x=fb.TILES_X, runs=True, paired=False, interpret=True))
    got = fb.render(fb.inputs(mix, 34, device="cpu")).numpy()
    assert got.shape == want.shape == (256, 1024)
    assert_images_match(
        np.ascontiguousarray(got).view(np.uint8).reshape(got.shape + (4,)),
        np.ascontiguousarray(want).view(np.uint8).reshape(want.shape + (4,)),
        err_msg=mix)


def test_entry_bench_fit_recovers_slope_and_intercept():
    T = fine_entry_bench.TILES_X * fine_entry_bench.TILES_Y
    ms = [T * (500.0 + 40.0 * n) / 1e6 for n in fine_entry_bench.NS]
    slope, icept = fine_entry_bench.fit(ms)
    assert abs(slope - 40.0) < 1e-6 and abs(icept - 500.0) < 1e-6


# ---- no card -------------------------------------------------------------

@pytest.mark.parametrize("tool", [div_probe, mosaic_numerics_probe,
                                  half_experiment, arg_delivery_bench,
                                  fine_entry_bench],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_main_raises_without_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main() if tool in (div_probe, half_experiment) else tool.main([])
