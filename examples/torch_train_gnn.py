"""Train a GNN for a few hundred steps with the fault-tolerant loop, on
the PyTorch port.  The port of ``examples/train_gnn.py``, step for step,
on ``repro_torch``: a rerun with the same ``--ckpt`` resumes from the
latest checkpoint there.

Run:  PYTHONPATH=src python examples/torch_train_gnn.py --steps 200 [--device cpu]

``--device`` defaults to ``cuda``; without a GPU the script raises unless
it is given ``--device cpu``.  ``--ckpt`` defaults to a folder under the
temporary directory.
"""

import argparse
import os
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.data import pipeline
from repro_torch.dist import sharding as shd
from repro_torch.models import gnn
from repro_torch.training import loop
from repro_torch.training import optimizer as opt_lib


def main(argv: list[str] | None = None) -> loop.TrainLoopResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gcn-cora", choices=["gcn-cora", "schnet", "nequip"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_gnn_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(None) if args.device == "cuda" else torch.device(args.device)

    rules = shd.Rules.from_mesh(None)
    cfg = registry.get_arch(args.arch).smoke()

    if args.arch == "gcn-cora":
        batch = pipeline.cora_like_batch(400, 1600, cfg.d_feat, cfg.n_classes, seed=0, device=device)
    else:
        batch = pipeline.molecules_batch(16, 12, 30, seed=0, device=device)

    def init_fn():
        params = gnn.INIT_FNS[cfg.name](cfg, seed=0, device=device)
        return params, opt_lib.get(cfg.optimizer).init(params)

    result = loop.run(
        init_fn=init_fn,
        train_step=gnn.make_gnn_train_step(cfg, rules),
        batch_fn=lambda step: batch,
        n_steps=args.steps,
        ckpt_dir=args.ckpt,
        ckpt_every=50,
        log_every=25,
    )
    print(f"resumed from step {result.start_step}; "
          f"loss {result.losses[0]:.4f} -> {result.losses[-1]:.4f}")
    return result


if __name__ == "__main__":
    main()
