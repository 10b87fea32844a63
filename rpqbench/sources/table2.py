"""Request source ``table2``: the paper's Table-2 queries (the mix's
``queries``, by name), each one request over every valid start of its
query (the reference's, worked out once a run and not counted in
``setup_s``)."""

from rpqbench.data.generators import TABLE2_QUERIES


def requests(mix: dict, inputs) -> list:
    """One pass: each query over all its valid starts, in the mix's order."""
    return [(TABLE2_QUERIES[q], inputs.valid_starts(TABLE2_QUERIES[q])) for q in mix["queries"]]
