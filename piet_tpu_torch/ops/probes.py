"""The kernels of the numerics probes and microbenchmarks
(``piet_tpu_torch/tools/``), each beside its plain PyTorch version.

Three kernels of ``csrc/probes.cu``, one C entry point each:

- :func:`probe_numerics`, the eight fine-math ops of
  ``tools/mosaic_numerics_probe.py`` (replaces its ``run_pallas``), and
  through :func:`probe_div` its division op, elementwise ``a / b``
  (replaces ``tools/div_probe.py::mosaic_div``; counted apart as
  "probe_div");
- :func:`probe_halfmix`, the state chain of ``tools/half_experiment.py``
  in f32, bf16 and packed bf16x2 (replaces its ``run``);
- :func:`probe_delivery`, the nine operand-delivery variants of
  ``tools/arg_delivery_bench.py`` (replaces its ``run``) over any number
  of tiles, with each tile's count of chain updates;

and two of ``csrc/mosaic_probe.cu``, the access-pattern probes of
``tools/mosaic_probe.py``:

- :func:`probe_mosaic_batch`, any of its 22 one-kernel probes at one or
  both fills in one launch, and :func:`probe_mosaic`, one probe at one
  fill (replace ``_compile``);
- :func:`probe_dma16`, its async copy of 16-lane rows into scratch
  (replaces ``_compile_dma16`` and ``_dma16_kernel``).

Dispatch as every kernel of the port (``kernels.on_cuda``): CPU tensors
run the plain version, CUDA tensors launch the kernel or raise.  The
plain versions repeat the kernels' arithmetic op for op; the tests and
``chip_smoke.py`` hold each kernel against its plain version bitwise.
"""

from __future__ import annotations

import torch

from .. import kernels
from .cmd_math import ieee_sqrt, srgb_encode_u32

F32 = torch.float32

#: The launch counters of the five kernels and of probe_numerics' division
#: (``kernels.LAUNCHES``); no frame runs them.
KERNELS = ("probe_div", "probe_numerics", "probe_halfmix", "probe_delivery",
           "probe_mosaic", "probe_dma16")

# ---- probe_numerics, probe_div -------------------------------------------

#: The tool's ops in its order (``mosaic_numerics_probe.OPS``; the
#: kernel's ``NumOp``), each with its operand count.
NUMERICS_OPS = {"div": 2, "sqrt": 1, "muladd2": 4, "lerp": 3,
                "fill_delta_chain": 5, "srgb_chain": 1, "ieee_sqrt": 1,
                "saturate_sub": 2}


def probe_numerics_plain(name: str, *ins: torch.Tensor) -> torch.Tensor:
    """The op ``name`` of the tool, every multiply and add rounded on its
    own (the order of the tool's strict numpy mirror)."""
    if name == "div":
        a, b = ins
        return a / b
    if name == "sqrt":
        # The IEEE square root: torch's f32 sqrt on the CPU is not
        # correctly rounded (1 ulp off numpy on some of the tool's
        # operands); the f64 root rounded to f32 is (53 >= 2 * 24 + 2).
        return torch.sqrt(ins[0].double()).to(F32)
    if name == "muladd2":
        a, b, c, d = ins
        return (a * b) + (c * d)
    if name == "lerp":
        r, f, w = ins
        return r + ((f - r) * w)
    if name == "fill_delta_chain":
        bq, dq, cq, xmin, xmax = ins
        t = (dq * dq) - (cq * cq)
        return ((bq + (0.5 * t)) - xmin) / (xmax - xmin)
    if name == "srgb_chain":
        return srgb_encode_u32(ins[0]).to(F32)
    if name == "ieee_sqrt":
        return ieee_sqrt(ins[0])
    if name == "saturate_sub":
        a, b = ins
        return torch.clamp(a - b, 0.0, 1.0)
    raise ValueError(f"unknown op {name!r}")


def _launch_numerics(counter: str, name: str, ins) -> torch.Tensor:
    """The kernel's op ``name`` on CUDA operands; counted as ``counter``.
    Each thread reads and writes 16 bytes at a time, so every operand
    must be 16-byte aligned (the output, fresh, is)."""
    for i, t in enumerate(ins):
        kernels.check_cuda_tensor(t, F32, f"operand {i}", ins[0].shape)
        if t.data_ptr() % 16:
            raise ValueError(f"operand {i} must be 16-byte aligned")
    out = torch.empty_like(ins[0])
    ptrs = [t.data_ptr() for t in ins]
    ptrs += [ptrs[0]] * (5 - len(ptrs))
    kernels.launch(counter, "piet_probe_numerics",
                   list(NUMERICS_OPS).index(name), *ptrs, out.data_ptr(),
                   out.numel())
    return out


def probe_numerics(name: str, *ins: torch.Tensor) -> torch.Tensor:
    """The fine-math op ``name`` (:data:`NUMERICS_OPS`), elementwise, on
    its same-shape f32 operands (on the card: contiguous, 16-byte
    aligned)."""
    if len(ins) != NUMERICS_OPS.get(name, -1):
        raise ValueError(f"op {name!r} takes {NUMERICS_OPS.get(name)} "
                         f"operands, got {len(ins)}")
    if not kernels.on_cuda(*ins):
        return probe_numerics_plain(name, *ins)
    return _launch_numerics("probe_numerics", name, ins)


def probe_div_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a / b


def probe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b, elementwise, of two same-shape f32 tensors: probe_numerics'
    division, counted as "probe_div"."""
    if not kernels.on_cuda(a, b):
        return probe_div_plain(a, b)
    return _launch_numerics("probe_div", "div", (a, b))


# ---- probe_halfmix -----------------------------------------------------

#: State types of the chain: name -> the kernel's kind.  "bfloat16x2" is
#: two bf16 to a 32-bit lane; it rounds as "bfloat16" does.
HALFMIX_KINDS = {"float32": 0, "bfloat16": 1, "bfloat16x2": 2}

#: f32 operations of one step of the chain at one element: a (2), b
#: (min, max; the negation is an operand modifier), the compare, c (mul,
#: add, select), d (mul, add, min), e (sub, mul, add), st0 and st1.
HALFMIX_OPS_PER_STEP = 16


def halfmix_init(rows: int, device="cpu") -> torch.Tensor:
    """The tool's starting state of one tile: (3, rows, 128) f32 planes
    st0 = 1, st1 = 2, st2 = 0."""
    init = torch.zeros((3, rows, 128), dtype=F32, device=device)
    init[0] = 1.0
    init[1] = 2.0
    return init


def probe_halfmix_plain(init: torch.Tensor, kind: str, tiles: int,
                        n_iter: int) -> torch.Tensor:
    dt = torch.bfloat16 if kind.startswith("bfloat16") else F32
    s0, s1, s2 = (p.to(dt).expand(tiles, *p.shape).clone() for p in init)
    for _ in range(n_iter):
        a = (s0 * 1.25) + s1
        b = torch.maximum(torch.minimum(a, torch.full_like(a, 8.0)), -a)
        mask = b.to(F32) > s2.to(F32)
        c = torch.where(mask, (b * 0.5) + s1, s2)
        d = torch.minimum(s0, (c * c) + b)
        e = s2 + ((d - b) * 0.125)
        s0 = torch.minimum(s0, d)
        s1 = torch.maximum(s1, e)
        s2 = e
    return s2.to(F32)


def probe_halfmix(init: torch.Tensor, kind: str, tiles: int,
                  n_iter: int) -> torch.Tensor:
    """``n_iter`` steps of the half-state chain over ``tiles`` copies of
    the tile ``init`` ((3, rows, 128) f32: st0, st1, st2), the state held
    as ``kind`` (:data:`HALFMIX_KINDS`).  Returns st2 as (tiles, rows,
    128) f32."""
    if kind not in HALFMIX_KINDS:
        raise ValueError(f"unknown state type {kind!r}")
    rows = init.shape[1]
    if not kernels.on_cuda(init):
        return probe_halfmix_plain(init, kind, tiles, n_iter)
    if not 1 <= rows <= 64:
        raise ValueError(f"rows {rows} outside [1, 64]")
    kernels.check_cuda_tensor(init, F32, "init", (3, rows, 128))
    out = torch.empty((tiles, rows, 128), dtype=F32, device=init.device)
    kernels.launch("probe_halfmix", "piet_probe_halfmix", init.data_ptr(),
                   out.data_ptr(), HALFMIX_KINDS[kind], rows, tiles, n_iter)
    return out


# ---- probe_delivery ----------------------------------------------------

#: The tool's variants in its order (``arg_delivery_bench.main``; the
#: kernel's ``Variant``): name -> (tile rows, how entries are delivered).
DELIVERY_VARIANTS = {
    "smem": (8, "global"), "vmem": (8, "staged"), "batch8": (8, "batch8"),
    "smem16": (16, "global"), "smem_win": (16, "window"),
    "batch816": (16, "batch8"), "smem32": (32, "global"),
    "smemw32": (32, "window"), "disp16": (16, "dispatch"),
}
#: Entries a staged chunk holds (``csrc/probes.cu`` CHUNK).
DELIVERY_CHUNK = 128
#: The state's start (the tool's 1e18).
STATE_INIT = 1e18
#: f32 operations of the chain at one pixel (dpx, dpy; dotp 3; the
#: divide, clamp 2, select; fx 2, fy 2; the field 3; the min), and of
#: one entry's own terms (lvx, lvy; denom 3; the compare).
CHAIN_OPS_PER_PIXEL = 17
CHAIN_OPS_PER_ENTRY = 6


def _field(data: torch.Tensor, rows: int) -> torch.Tensor:
    """The chain's squared field of every entry at every pixel of a
    (rows, 128) tile: (n, rows, 128), unaccumulated."""
    sx, sy, ex, ey = (data[:, k].view(-1, 1, 1) for k in range(4))
    X = torch.arange(128, dtype=F32, device=data.device).view(1, 1, 128)
    Y = torch.arange(rows, dtype=F32, device=data.device).view(1, rows, 1)
    lvx, lvy = ex - sx, ey - sy
    dpx, dpy = X - sx, Y - sy
    denom = (lvx * lvx) + (lvy * lvy)
    dotp = (lvx * dpx) + (lvy * dpy)
    t = torch.where(denom > 0.0, torch.clamp(dotp / denom, 0.0, 1.0), 0.0)
    fx = (lvx * t) - dpx
    fy = (lvy * t) - dpy
    return (fx * fx) + (fy * fy)


def window_rows(data: torch.Tensor, rows: int) -> torch.Tensor:
    """(n, rows) bool: the rows each entry updates under the row window
    (8 rows from rs where the line's band fits in them, else all)."""
    sy, ey, thr = data[:, 1], data[:, 3], data[:, 4]
    lo = torch.minimum(sy, ey) - thr
    hi = torch.maximum(sy, ey) + thr
    rs = torch.clamp(torch.floor(lo).to(torch.int32), 0, rows - 8)
    fits = (torch.ceil(hi).to(torch.int32) - rs) <= 8
    y = torch.arange(rows, device=data.device).view(1, rows)
    inside = (y >= rs.view(-1, 1)) & (y < rs.view(-1, 1) + 8)
    return ~fits.view(-1, 1) | inside


def _delivery_state(data: torch.Tensor, variant: str,
                    reps: int) -> torch.Tensor:
    """One tile's (rows, 128) state.  Every variant but the dispatch one
    min-accumulates the field, and a minimum of non-NaN values takes no
    order: the state is the minimum of STATE_INIT and the field of every
    entry that reaches the pixel, whatever the delivery and however often
    the stream repeats (reps > 0).  The dispatch variant's adds and
    multiplies run in the stream's order, entry by entry."""
    rows, how = DELIVERY_VARIANTS[variant]
    state = torch.full((rows, 128), STATE_INIT, dtype=F32,
                       device=data.device)
    if how != "dispatch":
        f = _field(data, rows)
        if how == "window":
            f = torch.where(window_rows(data, rows).unsqueeze(-1), f,
                            torch.inf)
        return torch.minimum(state, f.amin(0)) if reps > 0 else state
    words = data[:, :7].cpu().tolist()
    f = None
    for _ in range(reps):
        for j, (s0, s1, s2, _, _, s5, s6) in enumerate(words):
            tag = int(s5)
            if tag == 3:
                if f is None:
                    f = _field(data, rows)
                state = torch.minimum(state, f[j])
            if tag == 6:
                state = state + data[j, 0]
            if s6 == 4.0:
                state = torch.minimum(state, data[j, 1])
            if tag >= 5:
                state = state * data[j, 2]
    return state


def delivery_passes(data: torch.Tensor, variant: str, reps: int) -> int:
    """The (entry pass, tile row) chain updates that ``variant`` applies to
    one tile: every row for every entry; the entries' window rows; the
    rows of every tag-3 entry for the dispatch variant."""
    rows, how = DELIVERY_VARIANTS[variant]
    if how == "window":
        return reps * int(window_rows(data, rows).sum())
    if how == "dispatch":
        return reps * rows * int((data[:, 5].to(torch.int32) == 3).sum())
    return reps * rows * data.shape[0]


def probe_delivery_plain(data: torch.Tensor, variant: str, reps: int,
                         tiles: int = 1):
    """Every tile has the same origin and stream: the one-tile state and
    pass count, repeated."""
    state = _delivery_state(data, variant, reps)
    passes = torch.full((tiles,), delivery_passes(data, variant, reps),
                        dtype=torch.int32, device=data.device)
    return state.expand(tiles, *state.shape).clone(), passes


def probe_delivery(data: torch.Tensor, variant: str, reps: int,
                   tiles: int = 1):
    """The line_field_sq chain of every entry of ``data`` ((n, 16) f32
    rows: sx, sy, ex, ey, thr, tag, slot-1 tag, ...), ``reps`` times over
    the stream, min-accumulated into a (rows, 128) state from 1e18 as
    ``variant`` (:data:`DELIVERY_VARIANTS`) delivers the operands, on
    each of ``tiles`` tiles (the same tile, one block each on the card).
    Returns the states, (tiles, rows, 128) f32, and each tile's count of
    chain updates (:func:`delivery_passes`), (tiles,) int32."""
    if variant not in DELIVERY_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if data.ndim != 2 or data.shape[1] != 16 or data.shape[0] < 1:
        raise ValueError(f"data shape {tuple(data.shape)}")
    if not kernels.on_cuda(data):
        return probe_delivery_plain(data, variant, reps, tiles)
    rows, how = DELIVERY_VARIANTS[variant]
    n = data.shape[0]
    kernels.check_cuda_tensor(data, F32, "data")
    if how in ("staged", "batch8") and n % DELIVERY_CHUNK:
        raise ValueError(f"{variant}: {n} entries is not a multiple of "
                         f"{DELIVERY_CHUNK}")
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned")
    out = torch.empty((tiles, rows, 128), dtype=F32, device=data.device)
    passes = torch.empty((tiles,), dtype=torch.int32, device=data.device)
    kernels.launch("probe_delivery", "piet_probe_delivery", data.data_ptr(),
                   out.data_ptr(), passes.data_ptr(),
                   list(DELIVERY_VARIANTS).index(variant), n, reps, tiles)
    return out, passes


def delivery_ops(data: torch.Tensor, variant: str, reps: int,
                 tiles: int = 1) -> int:
    """f32 operations that ``variant`` must do on this data over
    ``tiles`` tiles: the chain at every pixel an entry reaches and each
    entry's own terms; the dispatch variant's adds and multiplies at
    every pixel where its tag takes them.  The one-time state init, the
    stores and the pass count are not counted."""
    rows, how = DELIVERY_VARIANTS[variant]
    n = data.shape[0]
    px = rows * 128
    if how == "window":
        reached = int(window_rows(data, rows).sum()) * 128
        per_rep = reached * CHAIN_OPS_PER_PIXEL + n * CHAIN_OPS_PER_ENTRY
    elif how == "dispatch":
        tag = data[:, 5].to(torch.int32)
        n3 = int((tag == 3).sum())
        per_rep = (n3 * (px * CHAIN_OPS_PER_PIXEL + CHAIN_OPS_PER_ENTRY)
                   + int((tag == 6).sum()) * px
                   + int((data[:, 6] == 4.0).sum()) * px
                   + int((tag >= 5).sum()) * px)
    else:
        per_rep = n * (px * CHAIN_OPS_PER_PIXEL + CHAIN_OPS_PER_ENTRY)
    return per_rep * reps * tiles


# ---- probe_mosaic, probe_dma16 ------------------------------------------

#: The tool's one-kernel probes in its order (``mosaic_probe.PROBES``
#: without dma_16lane; the kernel's ``Probe``), each with the shapes of
#: its f32 scratch (the tool's ``SCRATCH``; stack_scalars' is SMEM).
MOSAIC_PROBES = {
    "lane_slice_computed": (), "lane_slice_ref": (),
    "lane_slice_ref_dyn": (), "roll_dynamic": (), "sublane_dyn_load": (),
    "stack_scalars": ((8,),), "transpose_block": ((128, 16),),
    "bcast_and_reduce": (), "rmw_dyn_row": ((32, 128),),
    "major_dyn_scratch": ((8, 8, 128),), "pair_rows_bcast": (),
    "dynsub_statlane": ((128, 16),), "splat11": ((128, 16),),
    "grouped_sum_reshape": (), "roll_tree_sum": (), "repeat_sub": (),
    "concat0_41": (), "splat11_chain": ((128, 16),),
    "splat11_mul": ((128, 16),), "splat11_concat": ((128, 16),),
    "splat11_repeat": ((128, 16),), "dyn2_read": ((4, 16, 128),),
}
#: The probe's input and output (f32), and its grid, run in order.
MOSAIC_IN, MOSAIC_OUT, MOSAIC_STEPS = (16, 128), (8, 128), 4
#: Words of scratch that no step has written yet: the Pallas
#: interpreter's default (a quiet NaN) and its
#: ``uninitialized_memory="zero"``.
FILL_NAN = 0x7FC00000
FILLS = (FILL_NAN, 0)
#: probe_dma16's rows a copy moves (into slot 1 of the tool's (4, 512,
#: 16) scratch) and the rows between two steps' copies; its input must
#: hold the rows that step 3's copy reaches.
DMA16_ROWS, DMA16_STRIDE = 512, 128
DMA16_MIN_ROWS = (MOSAIC_STEPS - 1) * DMA16_STRIDE + DMA16_ROWS
#: The CPU's NaN for an invalid op on non-NaN operands.
_CPU_DEFAULT_NAN = -0x400000  # 0xffc00000 as int32


def _word(fill: int) -> int:
    """A 32-bit word as the signed int the C entry points take."""
    fill &= 0xFFFFFFFF
    return fill - (1 << 32) if fill >= 1 << 31 else fill


def _filled(shape, fill: int, device) -> torch.Tensor:
    return torch.full(shape, _word(fill), dtype=torch.int32,
                      device=device).view(F32)


def _quiet(a: torch.Tensor) -> torch.Tensor:
    return (a.view(torch.int32) | 0x00400000).view(F32)


def _cpu_nan(r: torch.Tensor, a, b) -> torch.Tensor:
    """``r``, the result of an op on ``a`` and ``b``, with the CPU's NaN
    word: the first NaN operand, quieted (the card's ALU gives the
    canonical 0x7fffffff instead; csrc/mosaic_probe.cu does the same)."""
    a = torch.as_tensor(a, dtype=F32, device=r.device).expand_as(r)
    b = torch.as_tensor(b, dtype=F32, device=r.device).expand_as(r)
    default = torch.tensor(_CPU_DEFAULT_NAN, dtype=torch.int32,
                           device=r.device).view(F32)
    nan = torch.where(a.isnan(), _quiet(a),
                      torch.where(b.isnan(), _quiet(b), default))
    return torch.where(r.isnan(), nan, r)


def _add(a, b):
    return _cpu_nan(a + b, a, b)


def _mul(a, b):
    return _cpu_nan(a * b, a, b)


def _min(a, b):
    """jnp.minimum: a NaN operand gives a NaN (its word, quieted)."""
    return torch.where(a.isnan(), _quiet(a),
                       torch.where(b.isnan(), _quiet(b), torch.minimum(a, b)))


def _splat(col: torch.Tensor) -> torch.Tensor:
    """``zeros((8, 128)) + col`` of an (8, 1) or (1, 128) operand."""
    return _add(0.0, col).expand(*MOSAIC_OUT)


def _mosaic_step(name: str, i: int, x: torch.Tensor, t) -> torch.Tensor:
    """Step ``i`` of probe ``name`` on the (16, 128) input ``x`` and its
    scratch tensors ``t`` (updated in place): the (8, 128) output block
    the step writes."""
    v = x[0:8]
    if name in ("transpose_block", "dynsub_statlane") or (
            name.startswith("splat11")):
        t[0].copy_(x.T)
    if name == "lane_slice_computed":
        return _splat(_mul(v, 2.0)[:, 3:4])
    if name == "lane_slice_ref":
        return _splat(v[:, 3:4])
    if name == "lane_slice_ref_dyn":
        return _splat(v[:, i:i + 1])
    if name == "roll_dynamic":
        return torch.roll(v, 16 * i, 1)
    if name == "sublane_dyn_load":
        return torch.cat([x[i:i + 4]] * 2)
    if name == "stack_scalars":
        return _splat(t[0].reshape(8, 1))
    if name == "transpose_block":
        return _splat(t[0][0:1, 0:1])
    if name == "bcast_and_reduce":
        a = v[:, 0:1]
        f = _add(_mul(a, x[0:1]), a)
        red = f[0:1]
        for r in range(1, 8):
            red = _min(red, f[r:r + 1])
        return _splat(red)
    if name == "rmw_dyn_row":
        t[0][i:i + 1] = _min(t[0][i:i + 1], x[0:1])
        return t[0][0:8].clone()
    if name == "major_dyn_scratch":
        t[0][0] = v
        return _splat(t[0][i, :, 2:3])
    if name in ("pair_rows_bcast", "repeat_sub"):
        return _splat(x[0:4, 0:1].repeat_interleave(2, 0))
    if name == "concat0_41":
        return _splat(torch.cat([x[0:4, 0:1]] * 2))
    if name == "dynsub_statlane":
        return _splat(torch.cat([t[0][4 * i:4 * i + 4, 2:3]] * 2))
    if name in ("splat11", "splat11_chain", "splat11_mul"):
        a, b = t[0][i:i + 1, 2:3], t[0][i:i + 1, 3:4]
        if name == "splat11_mul":
            ones = torch.ones((8, 1), dtype=F32, device=x.device)
            a, b = _mul(a, ones), _mul(b, ones)
        return _add(_mul(v, a), b)
    if name in ("splat11_concat", "splat11_repeat"):
        return _mul(v, t[0][i:i + 1, 2:3].expand(8, 1))
    if name == "grouped_sum_reshape":
        g = v.reshape(2, 4, 128)
        s = _add(_add(_add(g[:, 0], g[:, 1]), g[:, 2]), g[:, 3])
        return torch.cat([s] * 4)
    if name == "roll_tree_sum":
        s = v
        for k in (4, 2, 1):
            s = _add(s, torch.roll(s, k, 0))
        return s
    if name == "dyn2_read":
        t[0][0] = x
        return _splat(t[0][i, 2 * i:2 * i + 1, 2:3])
    raise ValueError(f"unknown probe {name!r}")


def probe_mosaic_plain(name: str, x: torch.Tensor,
                       fill: int = FILL_NAN) -> torch.Tensor:
    t = [_filled(s, fill, x.device) for s in MOSAIC_PROBES[name]]
    for i in range(MOSAIC_STEPS):
        out = _mosaic_step(name, i, x, t)
    return out.contiguous()


def probe_mosaic_batch_plain(names, x: torch.Tensor,
                             fills=FILLS) -> torch.Tensor:
    return torch.stack([torch.stack([probe_mosaic_plain(n, x, f)
                                     for n in names]) for f in fills])


_MOSAIC_INDEX = {n: p for p, n in enumerate(MOSAIC_PROBES)}


def _mosaic_mask(names, fills) -> int:
    """The kernel's probe mask: bit p for probe p of
    :data:`MOSAIC_PROBES`; ``names`` distinct and in that order."""
    for n in names:
        if n not in _MOSAIC_INDEX:
            raise ValueError(f"unknown probe {n!r}")
    idx = [_MOSAIC_INDEX[n] for n in names]
    if not idx or idx != sorted(set(idx)):
        raise ValueError(f"probes {list(names)}: expected one or more "
                         "distinct probes in the tool's order")
    if len(fills) not in (1, 2):
        raise ValueError(f"fills {fills}: expected one or two words")
    return sum(1 << p for p in idx)


def probe_mosaic_batch(names, x: torch.Tensor, fills=FILLS) -> torch.Tensor:
    """Probes ``names`` (distinct, in :data:`MOSAIC_PROBES` order) on the
    (16, 128) f32 input ``x``, each at every word of ``fills`` (one or
    two), in one launch: (len(fills), len(names), 8, 128) f32, the output
    step 3 of each left, its four steps run in order over scratch that
    starts as the fill word."""
    mask = _mosaic_mask(names, fills)
    if not kernels.on_cuda(x):
        return probe_mosaic_batch_plain(names, x, fills)
    kernels.check_cuda_tensor(x, F32, "x", MOSAIC_IN)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    out = torch.empty((len(fills), len(names)) + MOSAIC_OUT, dtype=F32,
                      device=x.device)
    kernels.launch("probe_mosaic", "piet_probe_mosaic", x.data_ptr(),
                   out.data_ptr(), mask, len(fills), _word(fills[0]),
                   _word(fills[-1]))
    return out


def probe_mosaic(name: str, x: torch.Tensor,
                 fill: int = FILL_NAN) -> torch.Tensor:
    """Probe ``name`` (:data:`MOSAIC_PROBES`) on the (16, 128) f32 input
    ``x``: its four steps in order over scratch that starts as the 32-bit
    word ``fill``; returns the (8, 128) f32 output step 3 left.  One
    launch of :func:`probe_mosaic_batch`'s kernel."""
    return probe_mosaic_batch([name], x, (fill,)).view(MOSAIC_OUT)


def probe_dma16_plain(x: torch.Tensor, fill: int = FILL_NAN) -> torch.Tensor:
    """``fill`` is not read: each step's copy fills the slot before the
    step reads it, and no other slot is touched."""
    for i in range(MOSAIC_STEPS):
        r0 = i * DMA16_STRIDE
        slot = x[r0:r0 + DMA16_ROWS]
        out = _splat(slot[i:i + 1, 3:4])
    return out.contiguous()


def probe_dma16(x: torch.Tensor, fill: int = FILL_NAN) -> torch.Tensor:
    """The dma_16lane probe on ``x`` ((>= 896, 16) f32, 16-byte aligned):
    at step i, rows 128 i .. 128 i + 511 copied into slot 1 of a (4, 512,
    16) scratch, then t[1, i, 3] splat into the (8, 128) f32 output;
    returns what step 3 left.  ``fill``, the scratch's word before step
    0 in the tool, cannot show: no word is read before a copy wrote it."""
    if x.ndim != 2 or x.shape[1] != 16 or x.shape[0] < DMA16_MIN_ROWS:
        raise ValueError(f"x shape {tuple(x.shape)}: expected (>= "
                         f"{DMA16_MIN_ROWS}, 16)")
    if not kernels.on_cuda(x):
        return probe_dma16_plain(x, fill)
    kernels.check_cuda_tensor(x, F32, "x")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    out = torch.empty(MOSAIC_OUT, dtype=F32, device=x.device)
    kernels.launch("probe_dma16", "piet_probe_dma16", x.data_ptr(),
                   out.data_ptr())
    return out
