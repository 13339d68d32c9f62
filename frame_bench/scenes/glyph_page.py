"""A page of body text (the frozen ``make_text_page``): ``n_glyphs``
DejaVu Sans glyphs at ``px`` on a ``line`` pitch inside ``margin`` of a
``size`` square, each glyph one combined fill."""

from ..reference.scene.text import make_text_page


def make(p: dict):
    return make_text_page(n_glyphs=p["n_glyphs"], size=p["size"],
                          px=p["px"], line=p["line"], margin=p["margin"])
