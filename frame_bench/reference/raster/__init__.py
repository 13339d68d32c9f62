"""The CPU golden tiler and fine rasterizer (frozen copies)."""
