"""Keyed integer sums: the coarse pass's per-candidate command counts and
winding deltas.

Port of ``piet_tpu/ops/keyed.py::keyed_sum``.  Values are small integers
(0/1/2 command counts, +-1 deltas), every element with |v| <= 256 and
every sum below 2^24, so an f32 sum is exact in any order.  Keys outside
[0, n_out) drop.  The JAX signature's ``lo_bound``/``hi_bound`` window
bounds are left out: only the TPU kernel reads them, to find each key
block's entries.

Two entry points share the CUDA kernel ``csrc/keyed.cu``:

- :func:`keyed_sum`, the counterpart of JAX's, one stream;
- :func:`record_keyed_sums`, both of the coarse pass's sums in one call,
  read in place from kernel B's (cap, 24) f32 records (ops/hitfuse.py):
  a memset and one launch in place of its plain version's column copies,
  key conversions, live mask and two sums.

:func:`keyed_sum_plain` and :func:`record_keyed_sums_plain` are their
plain PyTorch versions (``keyed_sum_xla`` of the JAX module, a segment
sum; and two of them on :func:`record_streams`, the sums' columns and
keys).
"""

from __future__ import annotations

import torch

from .. import kernels
from .hitfuse import K_CAND, K_DCAND, K_DVAL, K_NCMDS, OUT_WORDS

F32, I32 = torch.float32, torch.int32


def keyed_sum_plain(values: torch.Tensor, keys: torch.Tensor,
                    n_out: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`keyed_sum`: ``index_add_`` into
    n_out + 1 rows, the last catching the dropped keys."""
    k = torch.where((keys >= 0) & (keys < n_out), keys, n_out).to(
        torch.int64)
    acc = torch.zeros((n_out + 1, values.shape[1]), dtype=torch.float32,
                      device=values.device)
    acc.index_add_(0, k, values)
    return acc[:n_out]


def _check_range(n_out: int, n_ent: int) -> None:
    if not (n_out < 2 ** 24 and n_ent < 2 ** 24):
        raise ValueError("keyed sums: keys and entries must stay below 2^24")


def keyed_sum(values: torch.Tensor, keys: torch.Tensor,
              n_out: int) -> torch.Tensor:
    """out[k, v] = sum of values[e, v] over entries with keys[e] == k.

    Args:
      values: (E, V) f32, integer-valued, |v| <= 256, |sums| < 2^24.
      keys: (E,) int32; keys outside [0, n_out) contribute nowhere.
      n_out: number of output keys.

    Returns (n_out, V) f32 sums, exact and independent of order.
    """
    n_ent, width = values.shape
    _check_range(n_out, n_ent)
    if not kernels.on_cuda(values, keys):
        return keyed_sum_plain(values, keys, n_out)
    kernels.check_cuda_tensor(values, F32, "values", (n_ent, width))
    kernels.check_cuda_tensor(keys, I32, "keys", (n_ent,))
    out = torch.empty((n_out, width), dtype=F32, device=values.device)
    # One stream: rows of `width` values, int32 keys, f32 sums.
    kernels.launch("keyed", "piet_keyed", values.data_ptr(),
                   keys.data_ptr(), None, None, None, None, out.data_ptr(),
                   1, n_ent, width, n_out, width, 1, 0, 0)
    return out


def record_streams(rec: torch.Tensor, n_live: torch.Tensor, n_out: int):
    """The two sums of :func:`record_keyed_sums` as :func:`keyed_sum`
    arguments ``(values, keys, n_out)``: n_cmds by h_cand, and d_val by
    d_cand with the dropped entries (dead, or a zero value) keyed n_out."""
    live = torch.arange(rec.shape[0], dtype=I32, device=rec.device) < n_live
    d_val = rec[:, K_DVAL]
    dk = torch.where(live & (d_val != 0.0), rec[:, K_DCAND].to(I32), n_out)
    return ((rec[:, K_NCMDS][:, None].contiguous(), rec[:, K_CAND].to(I32),
             n_out), (d_val[:, None].contiguous(), dk, n_out))


def record_keyed_sums_plain(rec: torch.Tensor, n_live: torch.Tensor,
                            n_out: int):
    """Plain PyTorch version of :func:`record_keyed_sums`: two
    :func:`keyed_sum_plain` calls on :func:`record_streams`."""
    emit, delta = (keyed_sum_plain(*a)[:, 0]
                   for a in record_streams(rec, n_live, n_out))
    return emit.to(I32), delta


def record_keyed_sums(rec: torch.Tensor, n_live: torch.Tensor, n_out: int):
    """The coarse pass's two keyed sums over kernel B's hit records.

    Args:
      rec: (cap, 24) f32 hit records (ops/hitfuse.py::hit_records_fused).
      n_live: (1,) int32 live record count, on the device.
      n_out: number of candidates.

    Returns ``(cand_emit, delta)``: (n_out,) int32, the command counts
    (word ``n_cmds`` summed by word ``h_cand``), and (n_out,) f32, the
    winding deltas (word ``d_val`` by word ``d_cand`` over the live
    records).  On the card: one memset and one launch, reading ``rec`` in
    place.
    """
    cap = rec.shape[0]
    _check_range(n_out, cap)
    if not kernels.on_cuda(rec, n_live):
        return record_keyed_sums_plain(rec, n_live, n_out)
    kernels.check_cuda_tensor(rec, F32, "rec", (cap, OUT_WORDS))
    kernels.check_cuda_tensor(n_live.reshape(-1), I32, "n_live", (1,))
    out = torch.empty((2, n_out), dtype=F32, device=rec.device)
    # Two streams of one column each over the records' 24-word rows, f32
    # key words; stream 0 (the counts) sums into int32, stream 1 stops at
    # the live count.
    p = rec.data_ptr()
    kernels.launch("keyed", "piet_keyed", p + 4 * K_NCMDS, p + 4 * K_CAND,
                   None, p + 4 * K_DVAL, p + 4 * K_DCAND, n_live.data_ptr(),
                   out.data_ptr(), 2, cap, 1, n_out, OUT_WORDS, OUT_WORDS,
                   1, 0b01)
    return out[0].view(I32), out[1]
