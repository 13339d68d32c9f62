"""Row-slab rendering over several devices (or several slabs on one)."""

from .sharding import ShardedRenderer, make_sharded_render_fn

__all__ = ["ShardedRenderer", "make_sharded_render_fn"]
