"""The benchmark's entries-route configuration (``frame_bench/configs/
tiger_4k_entries.json``, cell ``tiger_4k_entries.replay``).

On the CPU: the configuration loads through ``frame_bench.spec`` and
resolves to the entries route; it is ``tiger_4k`` but for its name, route
and notes; and at its geometry cut by 8 (the tiger at scale 2.4 in
480x270, 32x128 tiles) the frame step that the replay entry builds
(``fit_capacities``, then ``make_render_fn`` with the route) gives a frame
bitwise equal to the frozen oracle's and to the dense route's, with no
``overflow_cmds`` among its stats and ``workload.failed`` False.

On the card (``cuda``): the full 4K configuration through the replay
entry against the oracle; one kernel D launch a replayed frame and no
``fine_dense`` or ``dense_tail``; the captured stage map names ``runs``,
``tile_reduce``, ``fine`` and ``present`` and puts no node in ``rest``.

No JAX here: on the card,
``python -m pytest --noconftest tests/test_torch_entries_config.py -q``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from frame_bench import check, spec, workload
from frame_bench.entries import replay
from piet_tpu_torch import tracing
from piet_tpu_torch.ops.coarse import PROBE_STAGES
from piet_tpu_torch.renderer import graph
from piet_tpu_torch.renderer.renderer import resolve_fine_impl

# Parallel test workers share the machine's cores: one torch thread
# each, or torch's pools oversubscribe them and stall every worker.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
NAME = "tiger_4k_entries"
CELL = "tiger_4k_entries.replay"
SEED = 2**31 + 7
#: The cut geometry: the 4K configuration's scale and viewport over 8.
CUT = 8


def _config(**over):
    return dict(spec.load_config(NAME), **over)


def _cut(config):
    return dict(config, scene=dict(config["scene"],
                                   scale=config["scene"]["scale"] / CUT),
                width=config["width"] // CUT,
                height=config["height"] // CUT)


def _entry(config, device):
    return replay.Entry(config, spec.load_traffic("replay"), SEED, device)


def test_the_configuration_loads_and_takes_the_entries_route():
    config = spec.load_config(NAME)
    assert config["fine_impl"] == "entries"
    assert resolve_fine_impl(config["fine_impl"]) == "entries"
    assert config["reduced"] == []
    assert len(config["source"]) <= 200
    assert "src/lib.rs" in config["source"] and "pallas" in config["source"]


@pytest.mark.parametrize("key", ["scene", "width", "height", "tile_width",
                                 "tile_height", "cmd_capacity", "reduced"])
def test_the_configuration_is_the_dense_cells_but_for_its_route(key):
    assert spec.load_config(NAME)[key] == spec.load_config("tiger_4k")[key]


def test_the_cell_replays_the_configuration_on_one_chip():
    bench = spec.load_benchmark(ROOT)
    c = spec.cell(bench, CELL)
    assert c["config"]["name"] == NAME
    assert c["traffic"]["entry"] == "replay"
    assert c["entry"]["chips"] == 1
    # Every metric the replayed dense tiger reports, this cell reports.
    assert [m["name"] for m in c["end_to_end"]] == [
        m["name"] for m in spec.cell(bench, "tiger_4k.replay")["end_to_end"]]
    assert [m["name"] for m in c["per_layer"]] == [
        m["name"] for m in spec.cell(bench, "tiger_4k.replay")["per_layer"]]


@pytest.fixture(scope="module")
def cut_frames():
    """The cut configuration's frame on each route, through the replay
    entry on the CPU: route -> (workload, its flat output)."""
    out = {}
    for route in ("entries", "dense"):
        wl = _entry(_cut(_config(fine_impl=route)), "cpu")
        out[route] = (wl, wl.frame(0))
    return out


def test_the_cut_frame_equals_the_frozen_oracle(cut_frames):
    wl, flat = cut_frames["entries"]
    assert wl.fine_impl == "entries"
    image = check.rgba8(wl.image(flat).numpy())
    checks, _ = check.check({0: image}, {0: wl.reference_scene(0)},
                            wl.cfg, workers=1)
    assert checks == {"pose0.pixels_off": {"value": 0, "limit": 0}}


def test_the_cut_frame_equals_the_dense_routes(cut_frames):
    (we, fe), (wd, fd) = cut_frames["entries"], cut_frames["dense"]
    assert we.cfg == wd.cfg
    np.testing.assert_array_equal(we.image(fe).numpy(),
                                  wd.image(fd).numpy())


def test_the_cut_frame_has_no_command_overflow_and_did_not_fail(cut_frames):
    wl, flat = cut_frames["entries"]
    stats = workload.stats_of(flat[wl.width * wl.height:], wl.step.keys)
    assert "overflow_cmds" not in stats
    assert stats["live_entries"] > 0
    assert wl.finish(flat) is False
    assert workload.failed(stats) is False


# ---- on the card ----------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def card_entry():
    """The full 4K configuration through the replay entry on the card,
    its graph captured by a first frame."""
    _need_card()
    wl = _entry(_config(), "cuda")
    before = tracing.graph_captures
    wl.finish(wl.frame(0))
    assert tracing.graph_captures == before + 1
    yield wl
    wl.close()


@pytest.mark.cuda
def test_cuda_the_4k_frame_equals_the_frozen_oracle(card_entry):
    wl = card_entry
    flat = wl.frame(1)
    assert wl.finish(flat) is False
    checks, _ = check.check({0: check.rgba8(wl.image(flat).cpu().numpy())},
                            {0: wl.reference_scene(0)}, wl.cfg)
    assert checks == {"pose0.pixels_off": {"value": 0, "limit": 0}}


@pytest.mark.cuda
def test_cuda_a_frame_launches_kernel_d_once_and_no_dense_kernel(card_entry):
    wl = card_entry
    tracing.reset_launches()
    for i in range(3):
        wl.finish(wl.frame(i))
    assert tracing.LAUNCHES["fine"] == 3
    assert tracing.LAUNCHES["fine_dense"] == 0
    assert tracing.LAUNCHES["dense_tail"] == 0
    assert tracing.LAUNCHES["fine_paired"] == 0


@pytest.mark.cuda
def test_cuda_the_stage_map_names_the_routes_stages(card_entry):
    wl = card_entry
    (entry,) = wl.step.step._entries.values()
    names = [s for s, _ in entry.stages]
    assert all(n > 0 for _, n in entry.stages), entry.stages
    assert "rest" not in names and "pairing" not in names, names
    assert names[-2:] == ["fine", "present"], names
    coarse = names[:-2]
    assert coarse == [s for s in PROBE_STAGES if s in coarse], names
    assert coarse[-2:] == ["runs", "tile_reduce"], names
    assert sum(n for _, n in entry.stages) == len(
        graph.device_ops(lambda: wl.step.step.fn(wl.staged)))
