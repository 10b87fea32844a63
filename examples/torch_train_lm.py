"""Train a ~small LM (reduced qwen3-family config) for a few hundred steps
with checkpoint/restart, on the PyTorch port.  The port of
``examples/train_lm.py``, step for step, on ``repro_torch``: a rerun with
the same ``--ckpt`` resumes from the latest checkpoint there.

Run:  PYTHONPATH=src python examples/torch_train_lm.py --steps 150 [--device cpu]

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
from repro_torch.models import transformer as tr
from repro_torch.training import loop
from repro_torch.training import optimizer as opt_lib


def main(argv: list[str] | None = None) -> loop.TrainLoopResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(None) if args.device == "cuda" else torch.device(args.device)

    rules = shd.Rules.from_mesh(None)
    cfg = registry.get_arch(args.arch).smoke()

    def init_fn():
        params = tr.init_params(cfg, seed=0, device=device)
        return params, opt_lib.get(cfg.optimizer).init(params)

    def batch_fn(step: int):
        return pipeline.lm_batch(cfg.vocab, batch=8, seq=64, step=step, seed=0, device=device)

    result = loop.run(
        init_fn=init_fn,
        train_step=tr.make_train_step(cfg, rules),
        batch_fn=batch_fn,
        n_steps=args.steps,
        ckpt_dir=args.ckpt,
        ckpt_every=50,
        log_every=25,
    )
    print(f"loss {result.losses[0]:.4f} -> {result.losses[-1]:.4f}")
    return result


if __name__ == "__main__":
    main()
