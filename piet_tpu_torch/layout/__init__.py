"""Layout codegen: single-source-of-truth packed struct layouts, and the
entry-stream word map (``entry_stream``).

Copies of the JAX package's ``piet_tpu/layout`` modules (``dsl``,
``packing``, ``emit_cpp``, ``emit_py``, ``modules``, ``entry_stream``),
with the same exports; ``python -m piet_tpu_torch.layout`` regenerates
the native library's headers into ``build/`` or, with ``--check``, holds
``cc/gen/`` against them (``__main__.py``)."""

from .dsl import Enum, Field, Module, Ref, Scalar, Struct, Vector
from .emit_cpp import emit_cpp
from .emit_py import describe
from .modules import ptcl_module, scene_module
from .packing import pack_module, pack_struct

__all__ = ["Enum", "Field", "Module", "Ref", "Scalar", "Struct", "Vector",
           "emit_cpp", "describe", "ptcl_module", "scene_module",
           "pack_module", "pack_struct"]
