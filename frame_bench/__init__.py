"""The benchmark of ``piet_tpu_torch``: frame time and its tail on the card.

``python -m frame_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line last.  Everything that belongs to one configuration, traffic mix
or per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it: ``configs/<name>.json``,
``traffic/<name>.json`` and ``metrics/<name with '.' as '_'>.py``; the
code of a traffic file's entry is ``entries/<entry>.py`` and of a
configuration's kind of scene ``scenes/<kind>.py``.
"""
