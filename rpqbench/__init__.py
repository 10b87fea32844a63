"""The benchmark of the port: whole Table-2 RPQs and a serving stream
through ``repro_torch.serve.QueryService``, on one card.  ``run.py``
runs one cell once; see ``PERF.md`` at the root of the checkout."""
