"""The benchmark of the PyTorch/CUDA port (``wire_tpu_torch``): one cell of
``BENCHMARK.json`` per run of ``benchmark/run.py``.  Every configuration,
traffic mix, task, count, reference and metric is a file of its own under
this folder, found by the name ``BENCHMARK.json`` gives it
(``lookup.py``)."""
