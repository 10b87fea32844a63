"""The one traffic generator: reads a mix's parameters
(``rpqbench/traffic/<name>.json``) and yields the cell's requests, each
(query, starts), with the warm-up apart.

The mix names its ``source`` of requests, ``rpqbench/sources/<source>.py``,
whose ``requests(mix, inputs)`` gives one pass of them in a fixed order,
and its ``client``, ``rpqbench/clients/<client>.py``, the loop that sends
them (``warmup(svc, requests, mix)``, ``drive(svc, stream, mix, seconds,
clock)``).  Both are found by name, so a new source or client is a new
file.

The source's pass, repeated, is cut into blocks of ``block`` requests,
and each block is served in an order drawn from the run's seed: every
seed serves the same requests block by block, so the work of a window
depends little on the seed.  The first ``warmup`` requests are the
warm-up, the rest the window's."""

from __future__ import annotations

import itertools
from typing import Iterator

import numpy as np

Request = tuple[str, np.ndarray]


def requests(mix: dict, source, inputs, seed: int) -> tuple[list[Request], Iterator[Request]]:
    rng = np.random.default_rng(seed)
    one_pass = source.requests(mix, inputs)
    block = mix["block"]

    def shuffled() -> Iterator[Request]:
        for lo in itertools.count(0, block):
            part = [one_pass[(lo + i) % len(one_pass)] for i in range(block)]
            yield from (part[i] for i in rng.permutation(block))

    stream = shuffled()
    return list(itertools.islice(stream, mix["warmup"])), stream
