"""Request source ``seed_paths``: the port's documented request stream
(the frozen ``generate`` of :mod:`rpqbench.data.workloads`, with the
mix's ``stream`` parameters and that stream's own fixed seed): random
walks over real paths, generalised into queries, 1 to 8 starts a
request, a pool of hot classes and fresh cold queries."""

from rpqbench.data.workloads import StreamConfig, generate


def requests(mix: dict, inputs) -> list:
    """One pass: the whole stream, in its own order."""
    return [(r.query, r.starts) for r in generate(inputs.graph, StreamConfig(**mix["stream"]))]
