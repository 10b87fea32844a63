"""``repro``'s dry run counts an LM's layer stack once, the port's counts
every layer (ROADMAP §C, a fault of the reference, left as it is).

Every LM step of ``repro`` scans its stacked layers (``models/
transformer.py`` ``hidden_states``), and XLA's cost analysis counts a
``while`` body once, so ``launch/analysis.py``'s FLOPs are those of one
layer however many the model has.  The input: ``configs/lm_common.py``
``lm_smoke("x")`` at ``n_layers`` 2, 4 and 8, ``forward`` on (4, 128)
int32 tokens, lowered by ``repro`` on ``jax.eval_shape`` of its
``init_params`` and counted by the port's ``launch.analysis.count_step``
on the same shapes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm_common as r_lm
from repro.dist import compat
from repro.models import transformer as r_tr

from repro_torch.configs import lm_common
from repro_torch.launch import analysis
from repro_torch.models import transformer as tr

torch.set_num_threads(1)

LAYERS = (2, 4, 8)
TOKENS = (4, 128)


@pytest.fixture(scope="module")
def flops():
    """FLOPs of one ``forward`` at each layer count: ``repro``'s cost
    analysis and the port's count."""
    out = {}
    for n in LAYERS:
        r_cfg = dataclasses.replace(r_lm.lm_smoke("x"), n_layers=n)
        pshapes = jax.eval_shape(lambda: r_tr.init_params(r_cfg, jax.random.key(0)))
        rules = r_tr.rules_for(r_cfg, None)
        lowered = jax.jit(lambda p, t: r_tr.forward(r_cfg, rules, p, t)).lower(
            pshapes, jax.ShapeDtypeStruct(TOKENS, jnp.int32))
        repro_flops = compat.cost_analysis_dict(lowered.compile())["flops"]
        cfg = dataclasses.replace(lm_common.lm_smoke("x"), n_layers=n)
        params = tr.init_params(cfg, 0, device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, TOKENS).astype(np.int32))
        port = analysis.count_step(lambda p, t: tr.forward(cfg, tr.rules_for(cfg), p, t), (params, tokens))
        assert port.output.shape == (*TOKENS, cfg.padded_vocab)
        out[n] = (repro_flops, port.flops)
    return out


def test_repro_counts_the_layer_stack_once(flops):
    """``repro``'s ``cost_analysis()["flops"]`` is the same at 2, 4 and 8
    layers."""
    counts = {n: r for n, (r, _) in flops.items()}
    assert counts[LAYERS[0]] > 0
    assert len(set(counts.values())) == 1, counts


def test_port_counts_every_layer(flops):
    """The port's ``count_step`` FLOPs grow with the layers, by the same
    amount for each added layer: the layer stack is counted whole."""
    counts = [flops[n][1] for n in LAYERS]
    per_layer = (counts[1] - counts[0]) / (LAYERS[1] - LAYERS[0])
    assert counts[0] < counts[1] < counts[2]
    assert per_layer > 0
    assert counts[2] - counts[1] == per_layer * (LAYERS[2] - LAYERS[1])
