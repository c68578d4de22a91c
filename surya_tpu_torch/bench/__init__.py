"""Measurements of the port: ``throughput`` (``python -m surya_tpu_torch
bench``, the counterpart of the root ``bench.py``), ``replay`` (the
reference-replay accuracy campaign on the card) and ``input_pipeline``
(host JPEG decode and the packed cache). The port's ``BENCHMARK.json``
is still to come (ROADMAP A5)."""
