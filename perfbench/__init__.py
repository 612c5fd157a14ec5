"""The benchmark of ``mdapy_tpu_torch``: one cell a run, driven by data.

``BENCHMARK.json`` at the checkout's root names the cells; each cell's
configuration (``configs/``), its driver (``drivers/``, named in the
configuration), traffic mix (``traffic/``) and metric readers
(``metrics/``) are files found by name.  ``run.py`` is the entry point,
``control.py`` reads what the limits of ``correct`` are set from.
"""
