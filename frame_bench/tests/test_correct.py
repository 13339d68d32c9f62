"""``correct`` comes out false for the control and for each fault a cell
can have, and true for the program, at a size a test run holds.

The runs skip the harness's look for a card (``run_cell`` on the CPU,
where the port runs its kernels' plain versions) and drive the rest of a
run: set-up, the closed loop, the kept frames, the comparison with the
frozen oracle.  The faults break the timed path underneath, in the image
a frame returns: a step that returns its state unchanged (a replay's
output never written; an animation's or rebuild's first frame returned
for every later pose), half of the frame left out (its lower rows), and
one pixel altered where it is produced.  A cell on one card has no
exchange between chips to leave out.
"""

import time

import pytest
import torch

from frame_bench import control, spec
from frame_bench.run import run_cell
from frame_bench import workload

torch.set_num_threads(1)


def _cell(traffic):
    bench = spec.load_benchmark(spec.HERE.parent)
    c = spec.cell(bench, "beziers_10k.replay")
    c["traffic"] = spec.load_traffic(traffic)
    own = next(w["name"] for w in bench["workloads"]
               if w["traffic"] == traffic)
    c["end_to_end"] = spec.cell(bench, own)["end_to_end"]
    c["config"].update(width=128, height=96)
    c["config"]["scene"].update(n=40, size=128)
    c["traffic"].update(poses=min(c["traffic"]["poses"], 2),
                        warmup_frames=1, host_frames=2, trace_frames=2)
    return c


def _fault(monkeypatch, traffic, fault):
    cls = workload.entry_class(traffic)
    orig = cls.frame
    first = {}

    def frame(self, i):
        out = orig(self, i)
        img = self.image(out)
        if "img" not in first:
            first["img"] = img.clone()
        if fault == "unchanged":
            if traffic == "replay":
                img.zero_()
            else:
                img.copy_(first["img"])
        elif fault == "half":
            img[img.shape[0] // 2:] = 0
        elif fault == "altered":
            img[img.shape[0] // 3, img.shape[1] // 3] ^= 1 << 16
        return out

    monkeypatch.setattr(cls, "frame", frame)


@pytest.mark.parametrize("traffic", ["replay", "rebuild", "anim"])
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_correct_is_false_under_each_fault(monkeypatch, traffic, fault):
    if fault is not None:
        _fault(monkeypatch, traffic, fault)
    c = _cell(traffic)
    res = run_cell(c, 2**31 + 21, 1.5, False, "cpu", time.perf_counter(),
                   workers=1)
    assert res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in c["end_to_end"]}
    assert res["correct"] is (fault is None), res["checks"]


@pytest.mark.parametrize("traffic", ["replay", "anim"])
def test_the_bf16_control_is_not_correct(traffic):
    for seed in (3, 2**31 + 4):
        r = control.control(_cell(traffic), seed, "cpu", workers=1)
        assert r["correct"] is False
        assert min(v["value"] for v in r["checks"].values()) > 0
