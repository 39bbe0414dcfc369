"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on NVIDIA
GPUs.  ``run.py`` runs one cell of ``BENCHMARK.json`` once; everything that
belongs to one configuration, traffic mix, model family or per-layer metric
sits in a file of its own, found by its name (see ``harness.py``)."""
