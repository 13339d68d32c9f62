"""The entry-stream word map (a copy of ``piet_tpu/layout/entry_stream.py``).

The JAX package's layout codegen (``dsl``, ``emit_cpp``, ``modules``,
``packing``) emits C++ headers for its native library; the port has no
use for it and keeps only the word map."""
