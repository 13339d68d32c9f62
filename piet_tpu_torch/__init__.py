"""piet-tpu on PyTorch: the renderer's entry-stream path for NVIDIA Hopper.

A second package beside ``piet_tpu/`` (the JAX reference).  It imports
``torch`` and never ``jax``.  The numpy host layer -- scenes, geometry,
the entry-stream word map, the CPU oracle, capacity fitting and the
host segment stage -- is imported from ``piet_tpu`` as it is; the device
pass is ported:

  ops/cmd_math.py   -- per-pixel command math and exact division/sqrt
  ops/candfuse.py   -- candidate-record expansion   (kernel A)
  ops/hitfuse.py    -- hit-record expansion + tests (kernel B)
  ops/keyed.py      -- keyed integer sums (torch glue)
  ops/sort.py       -- stable packed-key sort       (kernel C)
  ops/coarse.py     -- coarse binning -> entry stream
  ops/fine.py       -- entry-stream interpreter     (kernel D)
  renderer/         -- Renderer(cfg, device=...).render(scene)
  kernels.py        -- nvcc build, ctypes load, launch counters

Every kernel wrapper runs its plain-PyTorch version for a CPU tensor and
launches its CUDA kernel (csrc/) for a CUDA tensor; nothing falls back.
"""

__version__ = "0.1.0"
