"""Quickstart on the PyTorch port: answer Regular Path Queries on the
paper's example graph.  The port of ``examples/quickstart.py``, step for
step, on ``repro_torch``.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

``--device`` defaults to ``cuda``; without a GPU the script raises unless
it is given ``--device cpu``.
"""

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import paa
from repro_torch.graph.structure import example_graph, to_device_graph


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(None) if args.device == "cuda" else torch.device(args.device)

    g = example_graph()
    dg = to_device_graph(g, device)
    print(f"graph: {g.n_nodes} nodes, {g.n_edges} edges, labels {g.labels}")

    # §2.4 worked examples (node ids 1-based in the paper)
    for desc, query, start in [
        ("Q1  (single-source)", "a* b b", 1),
        ("QI3 (with inverse) ", "a* b^-1", 1),
    ]:
        ca = paa.compile_query(query, g)
        acc = paa.answers_single_source(ca, dg, start - 1).cpu().numpy()
        answers = sorted(int(v) + 1 for v in np.nonzero(acc)[0])
        print(f"{desc} {query!r} from node {start}: answers {answers}")

    # Q2: multi-source
    ca = paa.compile_query("a c (a|b)", g)
    starts = paa.valid_start_nodes(ca, g)
    srcs, dsts = paa.answers_multi_source(ca, dg, starts)
    pairs = sorted((int(a) + 1, int(b) + 1) for a, b in zip(srcs, dsts))
    print(f"Q2  (multi-source)  'a c (a|b)': pairs {pairs}")


if __name__ == "__main__":
    main()
