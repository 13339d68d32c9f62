"""The text page's configuration and cell: the cell loads, its scene
builds from the committed outline asset alone, the generator imports
nothing of the program, of JAX or of the font tools, and the fine
roofline counts a combined glyph fill's commands."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np

from frame_bench import spec
from frame_bench.metrics import fine_roofline as fr
from frame_bench.reference import band
from frame_bench.reference.config import TOLERANCE
from frame_bench.reference.config import RenderConfig as RefConfig
from frame_bench.reference.geometry import flatten_path
from frame_bench.reference.scene import text
from frame_bench.reference.scene.scene import SceneBuilder

ROOT = Path(__file__).resolve().parents[1]
CELL = "glyph_page_5k.replay"

#: The per-layer metrics the cell reports: every stage the replayed frame
#: runs (the page adds none).
PER_LAYER = {"device.idle_share", "frame_step.device_ops",
             "frame_step.host_ms", "coarse.device_ms",
             "coarse.binning_device_ms", "coarse.sort_device_ms",
             "coarse.tail_device_ms", "fine.device_ms", "fine_roofline",
             "present.device_ms", "setup.capture_s"}


def test_the_cell_loads():
    c = spec.cell(spec.load_benchmark(ROOT.parent), CELL)
    assert c["entry"]["chips"] == 1
    assert c["config"]["scene"] == {"kind": "glyph_page", "n_glyphs": 5000,
                                    "size": 1024, "px": 16, "line": 20,
                                    "margin": 8}
    assert c["traffic"]["entry"] == "replay"
    assert {m["name"] for m in c["end_to_end"]} == {
        "frame_ms", "frame_p95_ms", "setup_s"}
    assert {m["name"] for m in c["per_layer"]} == PER_LAYER
    for m in c["per_layer"]:
        spec.metric_module(m["name"])


def test_the_scene_builds_from_the_asset_alone():
    """In a fresh process: the configuration's scene for a large seed,
    with neither fontTools, matplotlib, torch nor the program loaded."""
    code = (
        "import sys\n"
        "from frame_bench import scenes, spec\n"
        "s = scenes.make_scene(spec.load_config('glyph_page_5k'), "
        "2**33 + 5)\n"
        "print(s.n_items, s.n_points)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'fontTools', 'matplotlib', 'torch', 'piet_tpu_torch', "
        "'piet_tpu', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.split("\n")
    assert out[0] == "7365 89969"
    assert out[1] == "[]"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_the_generator_imports_nothing_of_the_program_or_the_font_tools():
    files = [ROOT / "reference" / "scene" / "text.py",
             ROOT / "scenes" / "glyph_page.py"]
    bad = {"piet_tpu_torch", "piet_tpu", "jax", "jaxlib", "flax",
           "fontTools", "matplotlib", "torch"}
    assert [(p.name, m) for p in files for m in _imports(p)
            if m.split(".")[0] in bad] == []
    asset = ROOT / "reference" / "assets"
    assert (asset / "dejavu_sans_glyphs.json").is_file()
    assert (asset / "LICENSE_DEJAVU").is_file()


def _ptcl(subpaths, combined):
    b = SceneBuilder()
    b.fill_path(subpaths, text.INK, combined=combined)
    rcfg = RefConfig(width=192, height=128, tile_width=64, tile_height=32,
                     cmd_capacity=1024)
    return band.render(b.build(), rcfg, workers=0)[1]


def _only(ptcl, tag):
    keep = ptcl["tag"] == tag
    return dict(ptcl, tile=ptcl["tile"][keep], tag=ptcl["tag"][keep],
                args=ptcl["args"][keep])


def _count(ptcl):
    return fr.count(ptcl, 192, 128, 64, 32, 3)


def test_the_roofline_counts_a_combined_glyph():
    """An ``o`` at 96 px, one combined fill of two contours in tiles 3,
    6 and 9 (column 0, rows 1-3): the fill commands of both contours are
    counted, the counter's (the CONT subpath) as if filled alone, and the
    group's one DrawFill in each tile of the union box, every pixel of
    its tile (3 operations a pixel)."""
    font = text.load_glyphs()
    subs = flatten_path(text.glyph_path(font["glyphs"]["o"]["contours"],
                                        8.0, 100.0, 96 / 2048), TOLERANCE)
    group = _ptcl(subs, combined=True)
    alone = [_ptcl([s], combined=False) for s in subs]
    fills = [_only(p, fr.CMD_FILL) for p in [group] + alone]
    assert len(fills[0]["tag"]) == len(fills[1]["tag"]) + len(
        fills[2]["tag"]) == 24
    assert _count(fills[0])["ops"] == (_count(fills[1])["ops"]
                                       + _count(fills[2])["ops"]) > 0
    draw = _only(group, fr.CMD_DRAW_FILL)
    np.testing.assert_array_equal(draw["tile"], [3, 6, 9])
    assert _count(draw)["ops"] == 3 * 3 * 64 * 32
    assert _count(group)["ops"] == _count(fills[0])["ops"] + 3 * 3 * 64 * 32
