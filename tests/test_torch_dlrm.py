"""The port's DLRM serve and retrieval steps against ``repro``'s on the
CPU, on dlrm-mlperf's smoke config (3 tables of 64, 48 and 32 rows, 8
wide), with ``repro``'s parameters carried by
``interop.dlrm_params_from_numpy``.

The embeddings are bit-exact: the port's bags run B6's plain version,
which sums each bag in lookup order in the table's dtype, rounding a
bf16 sum after every lookup, as ``repro``'s ``segment_sum`` does on the
CPU (lookups are sorted stably by bag, so at ``multi_hot`` > 1 the order
is the same).  The f32 MLPs, the interaction and the retrieval's
candidate product sum in another order than XLA's, so logits,
probabilities, retrieval scores and the bottom MLP's output are held
to 1e-6 of the largest |repro| value; the retrieval's user vector is
exact when fed ``repro``'s MLP row, and its top-64 indices equal
``repro``'s up to ties."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import dlrm_mlperf as r_dlrm_cfg
from repro.core import planner as r_planner
from repro.data import pipeline as r_pipeline
from repro.dist import sharding as r_shd
from repro.models import dlrm as r_dlrm

from repro_torch import interop
from repro_torch.configs import dlrm_mlperf
from repro_torch.core import planner
from repro_torch.data import pipeline
from repro_torch.dist import sharding as shd
from repro_torch.models import dlrm

torch.set_num_threads(2)

R_RULES = r_shd.Rules.from_mesh(None)
RULES = shd.Rules.from_mesh(None)
TOL = 1e-6


def _bits(x) -> np.ndarray:
    """A bf16 or f32 array's raw bits, for exact comparison."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.view(torch.int32).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x.view(np.int32)


def _close(got, want) -> None:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def _models(multi_hot: int = 1):
    rcfg = dataclasses.replace(r_dlrm_cfg.smoke(), multi_hot=multi_hot)
    cfg = dataclasses.replace(dlrm_mlperf.smoke(), multi_hot=multi_hot)
    rp = r_dlrm.init_params(rcfg, jax.random.key(0))
    return rcfg, cfg, rp, interop.dlrm_params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


def _batch(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


@pytest.mark.parametrize("n_devices, batch", [(1, 1), (1, 512), (1, 262144), (8, 65536), (256, 1)])
def test_full_config_table_modes_and_padding(n_devices, batch):
    rcfg, cfg = r_dlrm_cfg.full(), dlrm_mlperf.full()
    assert cfg.padded_table_sizes == rcfg.padded_table_sizes
    assert sum(cfg.padded_table_sizes) == 187_771_785
    assert cfg.table_modes(n_devices, batch) == rcfg.table_modes(n_devices, batch)


def test_init_params_tree_shapes_and_seed():
    rcfg, cfg = r_dlrm_cfg.smoke(), dlrm_mlperf.smoke()
    want = r_dlrm.init_params(rcfg, jax.random.key(0))
    got = dlrm.init_params(cfg, seed=0, device="cpu")
    assert set(got["tables"]) == set(want["tables"])
    for name, t in got["tables"].items():
        assert tuple(t.shape) == want["tables"][name].shape and t.dtype == torch.bfloat16
    for part in ("bot", "top"):
        assert len(got[part]) == len(want[part])
        for g, w in zip(got[part], want[part]):
            assert tuple(g["w"].shape) == w["w"].shape and tuple(g["b"].shape) == w["b"].shape
            assert g["w"].dtype == torch.float32 and not g["b"].any()
    again = dlrm.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(got["tables"]["t0"], again["tables"]["t0"])
    assert not torch.equal(got["tables"]["t0"], dlrm.init_params(cfg, seed=1, device="cpu")["tables"]["t0"])


@pytest.mark.parametrize("multi_hot", [1, 3])
def test_embeddings_bit_exact(multi_hot):
    rcfg, cfg, rp, p = _models(multi_hot)
    rb = r_dlrm_cfg.smoke_batch(rcfg, "serve")
    b = _batch(rb)
    B = b["dense"].shape[0]
    r_bags = jnp.repeat(jnp.arange(B), multi_hot)
    bags = torch.arange(B, dtype=torch.int32).repeat_interleave(multi_hot)
    for i in range(cfg.n_sparse):
        want = r_dlrm.embedding_bag_local(rp["tables"][f"t{i}"], rb["sparse"][:, i, :].reshape(-1), r_bags, B)
        got = dlrm.embedding_bag_local(p["tables"][f"t{i}"], b["sparse"][:, i, :].reshape(-1), bags, B)
        assert got.dtype == torch.bfloat16
        assert np.array_equal(_bits(got), _bits(want)), i
        sharded = dlrm.embedding_bag_sharded(p["tables"][f"t{i}"], b["sparse"][:, i, :], RULES)
        assert torch.equal(sharded, got)


@pytest.mark.parametrize("multi_hot", [1, 3])
def test_serve_step_matches_repro(multi_hot):
    rcfg, cfg, rp, p = _models(multi_hot)
    rb = r_dlrm_cfg.smoke_batch(rcfg, "serve")
    b = dlrm_mlperf.smoke_batch(cfg, "serve", device="cpu")
    for k in rb:
        assert np.array_equal(np.asarray(rb[k]), b[k].numpy())
    _close(dlrm.forward(cfg, RULES, p, b), r_dlrm.forward(rcfg, R_RULES, rp, rb))
    probs = dlrm.make_serve_step(cfg, RULES)(p, b)
    assert probs.shape == (8,) and probs.dtype == torch.float32
    _close(probs, r_dlrm.make_serve_step(rcfg, R_RULES)(rp, rb))


@pytest.mark.parametrize("multi_hot", [1, 2])
def test_serve_step_on_pipeline_batch(multi_hot):
    """A 64-row batch from ``data/pipeline.py`` through both steps."""
    rcfg, cfg, rp, p = _models(multi_hot)
    rb = r_pipeline.dlrm_batch(rcfg.table_sizes, rcfg.n_dense, multi_hot, 64, step=3, seed=5)
    b = pipeline.dlrm_batch(cfg.table_sizes, cfg.n_dense, multi_hot, 64, step=3, seed=5, device="cpu")
    _close(dlrm.make_serve_step(cfg, RULES)(p, b), r_dlrm.make_serve_step(rcfg, R_RULES)(rp, rb))


@pytest.mark.parametrize("multi_hot", [1, 3])
def test_retrieval_step_matches_repro(multi_hot):
    rcfg, cfg, rp, p = _models(multi_hot)
    rb = r_dlrm_cfg.smoke_batch(rcfg, "retrieval")
    b = dlrm_mlperf.smoke_batch(cfg, "retrieval", device="cpu")
    w_scores, w_idx = (np.asarray(a) for a in r_dlrm.make_retrieval_step(rcfg, R_RULES)(rp, rb))
    scores, idx = dlrm.make_retrieval_step(cfg, RULES)(p, b)
    assert scores.shape == idx.shape == (64,)
    _close(scores, w_scores)
    user = _user(dlrm._mlp_apply(p["bot"], b["dense"])[0], dlrm.embedding_bags(cfg, RULES, p, b["sparse"][:1]))
    all_scores = (b["candidates"] @ user).numpy()
    differ = idx.numpy() != w_idx
    # a differing index is a tie: its score equals the one repro ranked there
    assert np.abs(all_scores[idx.numpy()[differ]] - all_scores[w_idx[differ]]).max(initial=0.0) <= (
        TOL * np.abs(w_scores).max()
    )


def _user(q: torch.Tensor, embs: list) -> torch.Tensor:
    """The retrieval step's user vector from the bottom MLP's row and the
    bags, as ``make_retrieval_step`` forms it."""
    return torch.stack([q] + [e[0].float() for e in embs]).mean(0)


def test_retrieval_user_vector_exact():
    """The bags and the mean are bit-exact; the bottom MLP's output is an
    f32 GEMM that each host's BLAS sums in its own order (1-2 ulp apart
    on some), so it is held to ``TOL`` as every DLRM MLP is, and the mean
    is fed ``repro``'s MLP row to stay exact."""
    rcfg, cfg, rp, p = _models(1)
    rb = r_dlrm_cfg.smoke_batch(rcfg, "retrieval")
    b = _batch(rb)
    r_q = r_dlrm._mlp_apply(rp["bot"], rb["dense"])
    r_bags = [
        r_dlrm.embedding_bag_local(rp["tables"][f"t{i}"], rb["sparse"][0, i, :], jnp.zeros(1, jnp.int32), 1)
        for i in range(rcfg.n_sparse)
    ]
    bags = dlrm.embedding_bags(cfg, RULES, p, b["sparse"][:1])
    for got, want in zip(bags, r_bags):
        assert np.array_equal(_bits(got), _bits(want))
    _close(dlrm._mlp_apply(p["bot"], b["dense"]), r_q)
    want = jnp.mean(jnp.stack([r_q[0]] + [e[0] for e in r_bags], 0), 0)
    assert np.array_equal(_bits(_user(torch.from_numpy(np.array(r_q[0])), bags)), _bits(want))


def test_sharded_table_runs_locally_off_mesh(monkeypatch):
    """With a replicate budget of 1 KiB the two larger smoke tables shard;
    off-mesh both packages still look them up locally, and agree."""

    def small_budget(placement):
        def decide(rows, dim, lookups, n_devices):
            return placement(rows, dim, lookups, n_devices, replicate_budget_bytes=1024)

        return decide

    monkeypatch.setattr(r_dlrm, "embedding_placement", small_budget(r_planner.embedding_placement))
    monkeypatch.setattr(dlrm, "embedding_placement", small_budget(planner.embedding_placement))
    rcfg, cfg, rp, p = _models(1)
    assert cfg.table_modes(1, 8) == rcfg.table_modes(1, 8) == ["shard", "shard", "replicate"]
    rb = r_dlrm_cfg.smoke_batch(rcfg, "serve")
    b = _batch(rb)
    _close(dlrm.make_serve_step(cfg, RULES)(p, b), r_dlrm.make_serve_step(rcfg, R_RULES)(rp, rb))
    rb = r_dlrm_cfg.smoke_batch(rcfg, "retrieval")
    _close(dlrm.make_retrieval_step(cfg, RULES)(p, _batch(rb))[0],
           r_dlrm.make_retrieval_step(rcfg, R_RULES)(rp, rb)[0])


def test_params_from_numpy_refuses_a_foreign_tree():
    with pytest.raises(KeyError):
        interop.dlrm_params_from_numpy({"bot": [], "top": []}, "cpu")
    with pytest.raises(KeyError):
        interop.lm_params_from_numpy({"embed": np.zeros(1)}, "cpu")
