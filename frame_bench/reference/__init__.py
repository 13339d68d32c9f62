"""The benchmark's plain reference: a frozen copy of the port's numpy
oracle and scene makers.

``config``, ``scene/{scene,color,svg}``, ``geometry/`` and
``raster/{cpu_tiler,cpu_fine,ptcl}`` are copies of the modules of the same
relative paths in ``piet_tpu_torch``, frozen here so that no later change
to the program moves the yardstick.  Two edits: ``scene/svg.py`` reads
the tiger from ``reference/assets/``, and
``raster/cpu_fine.py::render_tile`` takes the control's ``state_round``.
``scene/fixtures.py`` holds the one generator the benchmark uses.
``affine.py`` (a scene under an affine, as the port's device animation
computes it) and ``band.py`` (the oracle over bands of tile rows, in
worker processes) are the benchmark's own.

Nothing here imports the program, JAX or the JAX package: the check of
``frame_bench/tests/test_reference.py`` holds that.
"""
