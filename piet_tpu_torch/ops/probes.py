"""The kernels of the numerics probes and microbenchmarks
(``piet_tpu_torch/tools/``), each beside its plain PyTorch version.

Four kernels of ``csrc/probes.cu``, one C entry point each:

- :func:`probe_div`, elementwise ``a / b`` (replaces
  ``tools/div_probe.py::mosaic_div``);
- :func:`probe_numerics`, the eight fine-math ops of
  ``tools/mosaic_numerics_probe.py`` (replaces its ``run_pallas``);
- :func:`probe_halfmix`, the state chain of ``tools/half_experiment.py``
  in f32, bf16 and packed bf16x2 (replaces its ``run``);
- :func:`probe_delivery`, the nine operand-delivery variants of
  ``tools/arg_delivery_bench.py`` (replaces its ``run``).

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

#: The launch counters of the four kernels (``kernels.LAUNCHES``); no
#: frame runs them.
KERNELS = ("probe_div", "probe_numerics", "probe_halfmix", "probe_delivery")

# ---- probe_div -------------------------------------------------------


def probe_div_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a / b


def probe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b, elementwise, of two same-shape f32 tensors."""
    if not kernels.on_cuda(a, b):
        return probe_div_plain(a, b)
    kernels.check_cuda_tensor(a, F32, "a")
    kernels.check_cuda_tensor(b, F32, "b", a.shape)
    out = torch.empty_like(a)
    kernels.launch("probe_div", "piet_probe_div", a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), a.numel())
    return out


# ---- probe_numerics ----------------------------------------------------

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


def probe_numerics(name: str, *ins: torch.Tensor) -> torch.Tensor:
    """The fine-math op ``name`` (:data:`NUMERICS_OPS`), elementwise, on
    its same-shape f32 operands."""
    if len(ins) != NUMERICS_OPS.get(name, -1):
        raise ValueError(f"op {name!r} takes {NUMERICS_OPS.get(name)} "
                         f"operands, got {len(ins)}")
    if not kernels.on_cuda(*ins):
        return probe_numerics_plain(name, *ins)
    for i, t in enumerate(ins):
        kernels.check_cuda_tensor(t, F32, f"operand {i}", ins[0].shape)
    out = torch.empty_like(ins[0])
    ptrs = [t.data_ptr() for t in ins]
    ptrs += [ptrs[0]] * (5 - len(ptrs))
    kernels.launch("probe_numerics", "piet_probe_numerics",
                   list(NUMERICS_OPS).index(name), *ptrs, out.data_ptr(),
                   out.numel())
    return out


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


def probe_delivery_plain(data: torch.Tensor, variant: str,
                         reps: int) -> torch.Tensor:
    """Every variant but the dispatch one min-accumulates the field, and
    a minimum of non-NaN values takes no order: the state is the minimum
    of STATE_INIT and the field of every entry that reaches the pixel,
    whatever the delivery and however often the stream repeats (reps > 0).
    The dispatch variant's adds and multiplies run in the stream's order,
    entry by entry."""
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


def probe_delivery(data: torch.Tensor, variant: str,
                   reps: int) -> torch.Tensor:
    """The line_field_sq chain of every entry of ``data`` ((n, 16) f32
    rows: sx, sy, ex, ey, thr, tag, slot-1 tag, ...), ``reps`` times over
    the stream, min-accumulated into a (rows, 128) state from 1e18 as
    ``variant`` (:data:`DELIVERY_VARIANTS`) delivers the operands.
    Returns the state."""
    if variant not in DELIVERY_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if data.ndim != 2 or data.shape[1] != 16:
        raise ValueError(f"data shape {tuple(data.shape)}")
    if not kernels.on_cuda(data):
        return probe_delivery_plain(data, variant, reps)
    rows, how = DELIVERY_VARIANTS[variant]
    n = data.shape[0]
    kernels.check_cuda_tensor(data, F32, "data")
    if how in ("staged", "batch8") and n % DELIVERY_CHUNK:
        raise ValueError(f"{variant}: {n} entries is not a multiple of "
                         f"{DELIVERY_CHUNK}")
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned")
    out = torch.empty((rows, 128), dtype=F32, device=data.device)
    kernels.launch("probe_delivery", "piet_probe_delivery", data.data_ptr(),
                   out.data_ptr(), list(DELIVERY_VARIANTS).index(variant), n,
                   reps)
    return out


def delivery_ops(data: torch.Tensor, variant: str, reps: int) -> int:
    """f32 operations that ``variant`` must do on this data: the chain at
    every pixel an entry reaches and each entry's own terms; the dispatch
    variant's adds and multiplies at every pixel where its tag takes
    them.  The one-time state init and the stores are not counted."""
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
    return per_rep * reps
