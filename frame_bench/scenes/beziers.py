"""BASELINE's random cubic Béziers (the frozen ``make_random_beziers``):
``n`` paths in a ``size`` square, ``fill_fraction`` of them filled, from
the generator seed ``geometry_seed``."""

from ..reference.scene.fixtures import make_random_beziers


def make(p: dict):
    return make_random_beziers(n=p["n"], size=p["size"],
                               seed=p["geometry_seed"],
                               fill_fraction=p["fill_fraction"])
