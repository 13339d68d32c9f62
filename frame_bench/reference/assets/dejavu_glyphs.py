"""Write ``dejavu_sans_glyphs.json``: the DejaVu Sans outlines of the
characters the text page (``reference/scene/text.py``) sets.

    python3 frame_bench/reference/assets/dejavu_glyphs.py [DejaVuSans.ttf]

from the root of the repository.  The font is matplotlib's copy (``mpl-data/fonts/ttf/DejaVuSans.ttf``, found
through the installed matplotlib when no path is given), read with
fontTools.  Each glyph keeps its TrueType contours in font units, as
fontTools' ``RecordingPen`` gives them (``moveTo``, ``lineTo``,
``qCurveTo`` with its off-curve points and the closing on-curve point,
``closePath``), and its advance width.  The benchmark reads only the JSON:
neither fontTools nor matplotlib is imported by a run.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from fontTools.pens.recordingPen import RecordingPen
from fontTools.ttLib import TTFont

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))
from frame_bench.reference.scene.text import LOREM  # noqa: E402


def default_font() -> Path:
    import matplotlib
    return (Path(matplotlib.get_data_path()) / "fonts" / "ttf"
            / "DejaVuSans.ttf")


def glyphs(font_path: Path) -> dict:
    font = TTFont(str(font_path))
    cmap = font.getBestCmap()
    glyph_set = font.getGlyphSet()
    out = {}
    for ch in sorted(set(LOREM)):
        g = glyph_set[cmap[ord(ch)]]
        pen = RecordingPen()
        g.draw(pen)
        out[ch] = {"advance": g.width,
                   "contours": [[op, [list(p) for p in pts]]
                                for op, pts in pen.value]}
    return {"source": "matplotlib mpl-data/fonts/ttf/" + font_path.name,
            "family": font["name"].getDebugName(1),
            "version": font["name"].getDebugName(5),
            "units_per_em": font["head"].unitsPerEm,
            "glyphs": out}


def main(argv) -> int:
    font_path = Path(argv[1]) if len(argv) > 1 else default_font()
    data = glyphs(font_path)
    with open(HERE / "dejavu_sans_glyphs.json", "w", encoding="utf-8") as f:
        json.dump(data, f, separators=(",", ":"), sort_keys=True)
        f.write("\n")
    print(f"{len(data['glyphs'])} glyphs of {data['family']} "
          f"{data['version']}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
