"""Bisect a card-vs-CPU divergence of the coarse pass by stage and by
kernel, at the 224x224 tiger with loose capacities.

Port of ``tools/eng_bisect_probe.py``.  The pass runs with its stage
probes (``coarse_rasterize(with_probes=True)``: each stage's output
tensors) on the CPU, where every kernel's plain version runs, and on the
card; the probe reports the first stage whose arrays differ and the
mismatched words of each output leaf, then runs each kernel alone on the
CPU pass's inputs against its plain version (tools/engines.py) -- the
JAX tool's single-engine settings.

Usage: python -m piet_tpu_torch.tools.eng_bisect_probe
"""

from __future__ import annotations

from ..config import RenderConfig
from ..ops.coarse import PROBE_STAGES
from ..scene.svg import make_tiger
from . import card, engines

#: The JAX tool's configuration (its loose capacities).
CFG = RenderConfig(width=224, height=224, tile_height=16,
                   tile_width=128, cmd_capacity=2688, max_items=512,
                   max_points=1 << 15, max_segments=1 << 15,
                   max_hits=1 << 17, max_candidates=1 << 14,
                   max_deltas=1 << 15)


def stage_arrays(out) -> dict:
    """'stage[j]' -> the j-th output tensor of each stage that ran, on
    the host, in the pass's order."""
    probes = out.diag["probes"]
    return {f"{st}[{j}]": t.cpu() for st in PROBE_STAGES if st in probes
            for j, t in enumerate(probes[st])}


def run(setting: str, device, taps=None, cfg=CFG, scene=None):
    out = engines.run_pass(scene or make_tiger(scale=1.0), cfg, device,
                           taps=taps, with_probes=True)
    print(f"[{setting}] done", flush=True)
    return stage_arrays(out), engines.leaves(out)


def first_divergence(ref: dict, got: dict):
    """The first array of ``ref`` (in order) that ``got`` differs from,
    or None."""
    for k, a in ref.items():
        if k in got and engines.diff(a, got[k]).size:
            return k
    return None


def report(ref, got, setting="cuda") -> list:
    (ref_st, ref_lv), (st, lv) = ref, got
    bad = first_divergence(ref_st, st)
    nbad = [int(engines.diff(ref_lv[k], lv[k]).size) for k in ref_lv]
    lines = [f"[{setting}] first-div-stage={bad} leaf-mismatches={nbad}"]
    if bad is not None:
        lines.append(f"    probe[{bad}] words off: "
                     f"{engines.diff(ref_st[bad], st[bad]).size}")
    return lines


def main(argv=None) -> int:
    dev = card()
    taps = {}
    ref = run("cpu", "cpu", taps)
    print("\n".join(engines.bisect_lines(engines.bisect(taps, dev))),
          flush=True)
    for line in report(ref, run("cuda", dev)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
