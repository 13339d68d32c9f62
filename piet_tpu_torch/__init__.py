"""piet-tpu on PyTorch: the renderer's entry-stream path for NVIDIA Hopper.

A second package beside ``piet_tpu/`` (the JAX reference).  It imports
``torch`` and never ``jax``, and nothing of ``piet_tpu``: the numpy host
layer -- configuration, scenes and geometry, the entry-stream word map,
the CPU oracle, capacity fitting, the host segment stage, the PNG writer,
the wire format, the SVG loader and the drawing API (``api.py``) -- is
the port's own copy of the JAX package's modules, at the same
relative paths (``host.py`` re-exports it for scripts).  The device pass
is ported:

  ops/cmd_math.py   -- per-pixel command math and exact division/sqrt
  ops/candfuse.py   -- item rows + candidate expansion (kernel A)
  ops/hitfuse.py    -- hit-record expansion + tests (kernel B)
  ops/sort.py       -- stable packed-key sort       (kernel C)
  ops/fine.py       -- entry-stream interpreter     (kernel D)
  ops/expand.py     -- ragged expansion + row gather
  ops/keyed.py      -- keyed integer sums
  ops/gatherm.py    -- row gathers: K streams, segment endpoints,
                       candidate backdrops
  ops/coarse.py     -- coarse binning -> entry stream (host-staged or
                       device-derived segment stage)
  renderer/         -- Renderer(cfg).render(scene), on "cuda" by default;
                       make_render_fn / make_render_sequence_fn: a frame
                       (or N) as one CUDA graph replay (graph.py);
                       ResizableRenderer (resize.py)
  scene/affine.py   -- make_affine_render_fn: any scene under affines of t
  scene/animate.py  -- make_animated_render_fn: the animated fixture at t
  kernels.py        -- nvcc build, ctypes load, launch counters
  cli.py            -- python -m piet_tpu_torch: render, bench, animate,
                       profile, goldens, dump, info (on the card; --cpu)
  profiling.py      -- per-stage device times (graphed prefixes)
  roofline.py       -- the H100's peaks and each stage's least time
  native.py         -- the in-repo C++ library (cc/), built by the port
  entry.py          -- the flagship step and its staged tiger

Every kernel wrapper runs its plain-PyTorch version for a CPU tensor and
launches its CUDA kernel (csrc/) for a CUDA tensor; nothing falls back.
"""

__version__ = "0.2.0"
