"""The Ghostscript Tiger (the frozen ``make_tiger``) at ``scale``."""

from ..reference.scene.svg import make_tiger


def make(p: dict):
    return make_tiger(scale=p["scale"])
