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

The kernel runs every requested probe at every fill in one launch
(``probes.probe_mosaic_batch``); its plain version is the stack of the
per-probe ones, and the tool's lines come from that one batch.
"""

import functools
import importlib.util
import os
import re
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


#: Masks the tests hold the batch on, those the tool uses: its default
#: run (all 22), a few probes (among them three whose output shows the
#: fill) and one.
BATCHES = {"all": list(probes.MOSAIC_PROBES),
           "few": ["roll_dynamic", "stack_scalars", "rmw_dyn_row",
                   "splat11", "dyn2_read"],
           "one": ["dynsub_statlane"]}


@pytest.mark.parametrize("fills", [probes.FILLS, (0,), (probes.FILL_NAN,)],
                         ids=["both", "zero", "nan"])
@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_batch_plain_equals_per_probe_plain(batch, fills):
    """probe_mosaic_batch on a CPU tensor (its plain version) is the
    stack of the per-probe plain versions, fill by fill, probe by probe,
    with the NaN words in place."""
    names = BATCHES[batch]
    x = torch.from_numpy(_x(names[0]))
    got = probes.probe_mosaic_batch(names, x, fills)
    assert got.shape == (len(fills), len(names), 8, 128)
    for f, fill in enumerate(fills):
        for j, name in enumerate(names):
            want = probes.probe_mosaic_plain(name, x, fill)
            np.testing.assert_array_equal(_bits(got[f, j].numpy()),
                                          _bits(want.numpy()))
            np.testing.assert_array_equal(
                _bits(probes.probe_mosaic(name, x, fill).numpy()),
                _bits(want.numpy()))


def test_batch_mask_and_its_checks():
    """Bit p of the kernel's mask is probe p of the tool's order; the
    batch takes distinct probes in that order and one or two fills."""
    assert probes._mosaic_mask(["lane_slice_computed", "dyn2_read"],
                               probes.FILLS) == 1 | 1 << 21
    assert probes._mosaic_mask(list(probes.MOSAIC_PROBES), (0,)) == \
        (1 << 22) - 1
    x = torch.zeros(16, 128)
    for names, fills in ((["splat11", "roll_dynamic"], probes.FILLS),
                         (["splat11", "splat11"], probes.FILLS),
                         ([], probes.FILLS), (["nope"], probes.FILLS),
                         (["splat11"], ()), (["splat11"], (0, 0, 0))):
        with pytest.raises(ValueError):
            probes.probe_mosaic_batch(names, x, fills)


def test_kernel_probe_order_and_fill_set_match_the_tool():
    """csrc/mosaic_probe.cu's ``Probe`` enum is MOSAIC_PROBES' order (the
    mask's bits), and its ``reads_unwritten`` probes, the only ones whose
    scratch the kernel fills, include every probe whose plain output
    changes with the fill."""
    src = (ROOT / "piet_tpu_torch" / "csrc" / "mosaic_probe.cu").read_text()
    enum = re.search(r"enum Probe \{([^}]*)\}", src).group(1)
    assert [w.strip().lower() for w in enum.split(",")] == \
        list(probes.MOSAIC_PROBES) + ["n_probes"]
    body = re.search(r"reads_unwritten\(int p\) \{(.*?)\}", src,
                     re.S).group(1)
    filled = {w.lower() for w in re.findall(r"p == (\w+)", body)}
    x = torch.from_numpy(_x("splat11"))
    shows = {n for n in probes.MOSAIC_PROBES
             if not torch.equal(*(probes.probe_mosaic_plain(n, x, f).view(
                 torch.int32) for f in probes.FILLS))}
    assert shows == filled == {"stack_scalars", "rmw_dyn_row",
                               "major_dyn_scratch", "dyn2_read"}


def test_dma16_plain_does_not_read_the_fill():
    """No word of the DMA probe's scratch is read before a copy wrote it:
    the same words at both fills and at any other word."""
    x = torch.from_numpy(_x("dma_16lane"))
    want = _bits(probes.probe_dma16_plain(x).numpy())
    for fill in (*probes.FILLS, 0x7F800001, 0x3F800000):
        np.testing.assert_array_equal(
            _bits(probes.probe_dma16_plain(x, fill).numpy()), want)
        np.testing.assert_array_equal(
            _bits(probes.probe_dma16(x, fill).numpy()), want)


def test_tool_lines_keep_their_words_and_order(monkeypatch):
    """The tool's lines for all 23 probes, in the tool's order and in
    another, from one batched run of the 22 (both fills) and dma_16lane
    on its own."""
    calls = []
    batch = probes.probe_mosaic_batch

    def spy(names, x, fills=probes.FILLS):
        calls.append((list(names), tuple(fills)))
        return batch(names, x, fills)
    monkeypatch.setattr(probes, "probe_mosaic_batch", spy)
    names = mosaic_probe.PROBES
    assert mosaic_probe.probe(names, device="cpu") == [
        f"{n}: OK" for n in names]
    assert calls == [(list(probes.MOSAIC_PROBES), probes.FILLS)]
    mixed = ["dma_16lane", "splat11", "nope", "roll_dynamic", "splat11"]
    assert mosaic_probe.probe(mixed, device="cpu") == [
        "dma_16lane: OK", "splat11: OK", "nope: FAIL KeyError: 'nope'",
        "roll_dynamic: OK", "splat11: OK"]
    assert calls[1] == (["roll_dynamic", "splat11"], probes.FILLS)


def test_batch_error_fails_every_probe_of_the_batch(monkeypatch):
    """A CUDA error is sticky: the batch's error is every probe's line,
    and dma_16lane, which runs apart, is checked on its own."""
    def fails(names, x, fills=probes.FILLS):
        raise RuntimeError("piet_probe_mosaic failed: CUDA error 700\nmore")
    monkeypatch.setattr(probes, "probe_mosaic_batch", fails)
    lines = mosaic_probe.probe(mosaic_probe.PROBES, device="cpu")
    assert lines == [
        f"{n}: FAIL RuntimeError: piet_probe_mosaic failed: CUDA error 700"
        for n in probes.MOSAIC_PROBES] + ["dma_16lane: OK"]


def test_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        mosaic_probe.main([])
