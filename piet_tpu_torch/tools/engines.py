"""What the engine bisects share (``engine_probe``, ``eng_bisect_probe``,
``eng_array_probe``): the coarse pass on one device, bitwise comparisons
that name the first differing word, and each of the pass's kernels alone.

The JAX tools compare the pass's opt-in Pallas engines with its XLA
paths.  The port has no opt-in engines: on the CPU every kernel's plain
version runs (the JAX tools' "xla"), on the card every kernel (their
"pallas").  "One engine alone" is one kernel at a time: its inputs are
taken from a CPU pass (``coarse_rasterize(taps=...)``), moved to the
card, and the kernel's result is held bit for bit against the plain
version's on the same inputs.

The scene is staged without its host segment stage, so the pass derives
its segments on the device and every kernel of the coarse pass runs,
expand included; the result is bitwise the same either way.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops import candfuse, coarse, expand, gatherm, hitfuse, keyed, sort
from ..renderer.renderer import prepare_scene

#: The pass's outputs the tools compare, ``CoarseEntries``' leaves.
LEAVES = ("stream", "first", "n_entries", "counts", "solid")


def coarse_kw(cfg) -> dict:
    return dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                tile_w=cfg.tile_width, tile_h=cfg.tile_height,
                max_segments=cfg.max_segments, max_hits=cfg.max_hits,
                max_candidates=cfg.max_candidates)


def run_pass(scene, cfg, device, *, taps=None, with_probes=False):
    """The entries pass of ``scene`` staged on ``device`` (segments
    derived there)."""
    staged = prepare_scene(scene, cfg, device, seg_pre=False)
    return coarse.coarse_rasterize(staged, output="entries", pair="off",
                                   taps=taps, with_probes=with_probes,
                                   **coarse_kw(cfg))


def leaves(out) -> Dict[str, np.ndarray]:
    return {name: getattr(out, name).cpu().numpy() for name in LEAVES}


def words(x) -> np.ndarray:
    """A tensor or array as its 32-bit words (flat, on the host)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous().numpy()
    x = np.ascontiguousarray(x)
    return (x.view(np.uint32) if x.dtype.itemsize == 4 else x).reshape(-1)


def diff(a, b) -> np.ndarray:
    """Flat indices of the words where ``a`` and ``b`` differ (every word
    when their shapes differ)."""
    wa, wb = words(a), words(b)
    if wa.shape != wb.shape:
        return np.arange(max(wa.size, wb.size))
    return np.nonzero(wa != wb)[0]


def compare(a: Dict, b: Dict, names=None) -> Tuple[bool, List[str]]:
    """(all equal, report lines) of two name -> array dicts, bitwise:
    per differing array, its count and first index, and up to 4 words."""
    lines, ok = [], True
    for name in names or a:
        d = diff(a[name], b[name])
        if not d.size:
            continue
        ok = False
        wa, wb = words(a[name]), words(b[name])
        lines.append(f"    leaf {name}: {d.size}/{wa.size} words differ, "
                     f"first at flat index {d[0]}")
        for ix in d[:4]:
            va = f"{int(wa[ix]):#010x}" if ix < wa.size else "-"
            vb = f"{int(wb[ix]):#010x}" if ix < wb.size else "-"
            lines.append(f"      [{ix}] {va} vs {vb}")
    return ok, lines


def to_device(tree, device):
    """Tensors of ``tree`` (tensors, tuples, named tuples, lists, dicts)
    moved to ``device``; everything else as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    if isinstance(tree, tuple):
        vals = [to_device(v, device) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


def _candfuse(args, plain):
    (scene, rect_kw), (ci, akw) = args
    rows = (candfuse.cand_inputs_plain if plain else candfuse.cand_prep)(
        scene, **rect_kw)
    fused = (candfuse.cand_records_fused_plain if plain
             else candfuse.cand_records_fused)(*ci, **akw)
    return tuple(rows) + tuple(fused)


def _hitfuse(args, plain):
    hargs, kw = args
    return ((hitfuse.hit_records_fused_plain if plain
             else hitfuse.hit_records_fused)(*hargs, **kw),)


def _sort(args, plain):
    keys, val, bounds = args
    k, v = (sort.stable_sort_multi_plain(keys, val) if plain
            else sort.stable_sort_multi(keys, val, bounds))
    return tuple(k) + (v,)


def _keyed(args, plain):
    return tuple((keyed.record_keyed_sums_plain if plain
                  else keyed.record_keyed_sums)(*args))


def _gatherm(args, plain):
    out = ()
    for site, a in args:
        r = gatherm.SITES[site][1 if plain else 0](*a)
        out += r if isinstance(r, tuple) else (r,)
    return out


def _expand(args, plain):
    return ((expand.expand_rows_plain if plain
             else expand.expand_rows)(*args),)


#: kernel -> (the taps it reads, its call on them: (args, plain) ->
#: outputs).  Kernel A counts its item rows and its expansion.
KERNELS = {
    "candfuse": (("cand_inputs", "candfuse"), _candfuse),
    "hitfuse": (("hitfuse",), _hitfuse),
    "sort": (("sort",), _sort),
    "keyed": (("keyed",), _keyed),
    "gatherm": (("gatherm",), _gatherm),
    "expand": (("expand",), _expand),
}


def bisect(taps, device) -> Dict[str, dict]:
    """Each kernel of a pass alone: its inputs (a CPU pass's ``taps``)
    moved to ``device``, its outputs held bitwise against the plain
    version's on the CPU inputs.  kernel -> {"words_off", "words",
    "first"}: ``first`` is (output, flat index) of the first differing
    word, or None."""
    res = {}
    for name, (keys, call) in KERNELS.items():
        if keys[0] not in taps:
            continue
        args = taps[keys[0]] if len(keys) == 1 else tuple(taps[k]
                                                           for k in keys)
        got = call(to_device(args, device), False)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        want = call(args, True)
        off = n = 0
        first = None
        for j, (g, w) in enumerate(zip(got, want)):
            d = diff(g, w)
            if d.size and first is None:
                first = (j, int(d[0]))
            off += int(d.size)
            n += words(w).size
        res[name] = {"words_off": off, "words": n, "first": first}
    return res


def bisect_lines(res: Dict[str, dict]) -> List[str]:
    return [f"  {k} alone vs plain: "
            f"{'IDENTICAL' if r['words_off'] == 0 else 'DIFFER'} "
            f"({r['words_off']}/{r['words']} words"
            + (f", first at output {r['first'][0]} flat index "
               f"{r['first'][1]}" if r["first"] else "") + ")"
            for k, r in res.items()]
