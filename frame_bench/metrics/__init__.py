"""Per-layer metrics, one reader a module, found by the metric's name
(dots as underscores).  Each declares ``NAME``, ``UNIT``, ``LAYER``,
``SOURCE`` and ``MOVES`` and has ``read(ctx)``, which returns the value,
or None where the traced run holds nothing for it to read."""
