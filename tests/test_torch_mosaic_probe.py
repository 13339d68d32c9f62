"""The access-pattern probes of tools/mosaic_probe.py: the port's plain
versions (ops/probes.py::probe_mosaic_plain, probe_dma16_plain, what the
kernels of csrc/mosaic_probe.cu are held to on the card) against the JAX
tool's Pallas kernels run in interpret mode on the CPU.

The tool only compiles its probes, but each defines a result: the grid
(4,) runs in order, the (8, 128) output block stays resident, so the
result is what step 3 left, with scratch carried from step to step.  Four
probes read scratch they never wrote; the interpreter fills it with the
quiet NaN 0x7fc00000 by default (``interpret=True``) and with zeros under
``pltpu.InterpretParams(uninitialized_memory="zero")``, and the plain
versions take the same word as their fill.  Both fills are held, bitwise
with the NaN words in place, except where the interpreter contracts a
multiply and an add into an FMA (it does so even under
``jax.disable_jit()``): bcast_and_reduce and the three (1, 1)-splat
probes that compute x * a + b.  Those are held within a stated bound
against the interpreter, and bitwise against a numpy mirror of the
unfused expression, which is what the kernel built with -fmad=false
computes.
"""

import functools
import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from piet_tpu_torch.ops import probes  # noqa: E402
from piet_tpu_torch.tools import mosaic_probe  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
F = np.float32
FILLS = {"nan": probes.FILL_NAN, "zero": 0}
#: Probes whose interpreted kernel contracts x * a + b into an FMA.
CONTRACTED = ("bcast_and_reduce", "splat11", "splat11_chain", "splat11_mul")
#: The contraction's bound, in ulps of the expression's largest term: the
#: product's rounding, which the FMA skips (<= 1/2 ulp of the product),
#: and the sum's rounding on either side (<= 1 ulp of the sum, which is
#: <= 2 of the term) -- 2.5.  Measured on default_rng(0)'s input: 2.0
#: for the splats, 1.0 for bcast_and_reduce (357 and 328 words of 1,024
#: differ).
CONTRACTION_ULPS = 2.5


@functools.lru_cache(maxsize=None)
def _jax_tool():
    env, path = dict(os.environ), list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_tool_mosaic_probe", ROOT / "tools" / "mosaic_probe.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    return mod


def _x(name):
    return mosaic_probe.probe_input(name)


@functools.lru_cache(maxsize=None)
def _interpreted(name: str, fill: str) -> np.ndarray:
    """The JAX probe's result in interpret mode, ``fill`` the
    interpreter's word for unwritten scratch."""
    tool = _jax_tool()
    interpret = (True if fill == "nan" else
                 pltpu.InterpretParams(uninitialized_memory="zero"))
    out_spec = pl.BlockSpec((8, 128), lambda i: (0, 0),
                            memory_space=pltpu.VMEM)
    out_shape = jax.ShapeDtypeStruct((8, 128), jnp.float32)
    if name == "dma_16lane":
        # The memory space the tool declares (pltpu.ANY; pl.ANY now).
        f = pl.pallas_call(
            tool._dma16_kernel, grid=(4,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=out_spec, out_shape=out_shape,
            scratch_shapes=[pltpu.VMEM((4, 512, 16), jnp.float32),
                            pltpu.SemaphoreType.DMA],
            interpret=interpret)
    else:
        f = pl.pallas_call(
            tool.PROBES[name], grid=(4,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=out_spec, out_shape=out_shape,
            scratch_shapes=list(tool.SCRATCH.get(name, ())),
            interpret=interpret)
    return np.asarray(jax.jit(f)(_x(name)))


def _plain(name: str, fill: str, x=None) -> np.ndarray:
    x = torch.from_numpy(_x(name) if x is None else x)
    return mosaic_probe.run_plain(name, x, FILLS[fill]).numpy()


def _bits(a):
    return np.ascontiguousarray(a, F).view(np.uint32)


def _ulp(v):
    return np.spacing(np.abs(np.asarray(v, F))).astype(np.float64)


def test_probe_list_is_the_tools():
    tool = _jax_tool()
    assert mosaic_probe.PROBES == list(tool.PROBES)
    assert len(mosaic_probe.PROBES) == 23
    for name, shapes in probes.MOSAIC_PROBES.items():
        assert [tuple(s.shape) for s in tool.SCRATCH.get(name, ())] == \
            list(shapes), name


@pytest.mark.parametrize("fill", sorted(FILLS))
@pytest.mark.parametrize("name", mosaic_probe.PROBES)
def test_plain_equals_interpreted_probe(name, fill):
    got, want = _plain(name, fill), _interpreted(name, fill)
    assert got.shape == want.shape == (8, 128)
    # NaN words in the same places, as the fill word itself.
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    nan_words = _bits(got)[np.isnan(got)]
    assert (nan_words == probes.FILL_NAN).all()
    if fill == "zero":
        assert not np.isnan(got).any()
    if name not in CONTRACTED:
        np.testing.assert_array_equal(_bits(got), _bits(want))
        return
    x = _x(name)
    if name == "bcast_and_reduce":
        a, xs = x[0:8, 0:1], x[0:1]
        term = np.maximum(np.abs(a * xs), np.abs(a)).max(0, keepdims=True)
    else:
        a, b = x[2, 3], x[3, 3]
        term = np.maximum(np.abs(x[0:8] * a), np.abs(b))
    err = np.abs(got.astype(np.float64) - want) / _ulp(term)
    assert err.max() <= CONTRACTION_ULPS, err.max()


def _unfused_mirror(name, x):
    """numpy, every multiply and add rounded on its own, at step 3."""
    if name == "bcast_and_reduce":
        a, xs = x[0:8, 0:1], x[0:1]
        f = (a * xs).astype(F) + a
        return np.broadcast_to(F(0) + f.min(0, keepdims=True), (8, 128))
    a, b = x[2, 3], x[3, 3]   # the transposed block's [i, 2] and [i, 3]
    if name == "splat11_mul":
        a, b = a * F(1), b * F(1)
    return (x[0:8] * a).astype(F) + b


@pytest.mark.parametrize("name", CONTRACTED)
def test_contracted_probes_equal_unfused_numpy(name):
    x = _x(name)
    for fill in FILLS:
        np.testing.assert_array_equal(
            _bits(_plain(name, fill)), _bits(_unfused_mirror(name, x)))


def test_dma16_reads_the_row_of_step_3():
    """dma_16lane on arange(1024 * 16): t[1, 3, 3] = in[3 * 128 + 3, 3]
    = 6195, in the kernel and the interpreter alike."""
    x = np.arange(1024 * 16, dtype=F).reshape(1024, 16)
    got = _plain("dma_16lane", "nan", x)
    assert (got == 6195.0).all()
    with pytest.raises(ValueError):
        probes.probe_dma16(torch.zeros((895, 16)))


def test_probe_rejects_unknown_names_and_reports_as_the_tool():
    with pytest.raises(ValueError):
        probes.probe_mosaic("no_such_probe", torch.zeros(16, 128))
    lines = mosaic_probe.probe(["splat11", "dma_16lane", "nope"],
                               device="cpu")
    assert lines[:2] == ["splat11: OK", "dma_16lane: OK"]
    assert lines[2] == "nope: FAIL KeyError: 'nope'"


def test_fill_word_reaches_unwritten_scratch():
    """Any fill word: a NaN carries its quiet form through the
    arithmetic (the CPU's rule, which the kernel repeats), a raw read
    carries it as it is, a number carries its value."""
    x = torch.from_numpy(_x("rmw_dyn_row"))
    out = probes.probe_mosaic("rmw_dyn_row", x, 0x7F800001)
    words = out.view(torch.int32)
    assert (words[4:] == 0x7F800001).all()         # never written
    assert (words[:4] == 0x7FC00001).all()         # min(fill, x), quieted
    out = probes.probe_mosaic("stack_scalars", x, 0x3F800000)
    assert (out == 1.0).all()


def test_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        mosaic_probe.main([])
