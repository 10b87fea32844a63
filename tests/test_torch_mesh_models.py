"""The models' mesh programs over ``gloo`` ranks on the CPU: DLRM's
row-sharded ``embedding_bag_sharded`` and its serve and retrieval steps,
and the four GNN forwards on edges sharded over ranks, against the
port's one-card run (``mesh=None``) and against ``repro`` under
``shd.use_mesh`` on a (4, 2) mesh of 8 forced host devices.

One spawn of 4 ``gloo`` ranks runs every case on a (2, 1) mesh (ranks 0
and 1), a (4, 1) and a (2, 2) mesh.  The weights are drawn once here, by
the port's inits, as numpy arrays: the ranks carry them in with
``interop`` (``dlrm_params_from_numpy``, ``gnn_params_from_numpy`` and,
for a rank's row shard of a table, ``table_row_shard_from_numpy``), and
``repro`` takes them as they are.

Tolerances, as the largest |difference| over the largest |value|:
* a bag at ``multi_hot`` 1 has one lookup, so its psum adds zeros:
  bit for bit; at ``multi_hot`` 3 each rank's partial rounds apart: f32
  1e-6, bf16 2e-2;
* serve probabilities and retrieval scores 1e-6 (f32 MLPs) at
  ``multi_hot`` 1, 2e-2 at 3 (their bf16 bags round apart); the top 64
  equal up to ties;
* GNN outputs 1e-5, EquiformerV2 1e-4: scatters split over ranks sum in
  another order; GCN's degrees are integers in f32 and exact;
* EquiformerV2 on a graph of 150,000 nodes, which ``equiformer_energy``
  sends to ``equiformer_energy_big`` on a mesh (bf16 node state): the
  same energy on every rank, BIG_TOL of ``repro``'s and of the plain
  twin of that path on one card (``equiformer_atoms_big_plain``, whose
  sums run in f32).

The DLRM cases shard the smoke config's tables of more than 40 rows
(64 and 48) and replicate the third, by a rule patched into both
packages: the paper's rule replicates every table of a smoke size.
"""

import contextlib
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import types

import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import interop
from repro_torch.configs import dlrm_mlperf, gnn_common, registry
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.launch import ranks
from repro_torch.models import dlrm, gnn

torch.set_num_threads(1)

SHAPES = [(2, 1), (4, 1), (2, 2)]
WORLD = 4
SPAWN_TIMEOUT_S = 150
GNN_ARCHS = ["gcn-cora", "schnet", "nequip", "equiformer-v2"]
HOTS = (1, 3)
BAG_ROWS, BAG_DIM = 51, 16  # 51 rows: the second of two shards ends in a padding row
BAG_BATCHES = (12, 13)  # 13 does not divide over the batch axes: every rank takes it whole
SHARD_ABOVE_ROWS = 40
BIG_NODES, BIG_EDGES, BIG_TOL = 150_000, 128, 5e-3  # repro's _BIG_GRAPH_NODES


# ---------------------------------------------------------------------------
# inputs, drawn once
# ---------------------------------------------------------------------------


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _tree(tree):
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v) for v in tree]
    return _numpy(tree)


def _dlrm_cfg(hot: int):
    return dataclasses.replace(dlrm_mlperf.smoke(), multi_hot=hot)


def _inputs() -> dict:
    rng = np.random.default_rng(7)
    bags = {}
    for dtype in ("f32", "bf16"):
        table = rng.normal(size=(BAG_ROWS, BAG_DIM)).astype(np.float32)
        if dtype == "bf16":
            table = table.astype(ml_dtypes.bfloat16)
        for b in BAG_BATCHES:
            for hot in HOTS:
                bags[dtype, b, hot] = (table, rng.integers(0, BAG_ROWS, (b, hot)).astype(np.int32))
    models = {}
    for hot in HOTS:
        cfg = _dlrm_cfg(hot)
        sizes = np.asarray(cfg.table_sizes)
        models[hot] = {
            "params": _tree(dlrm.init_params(cfg, seed=hot, device="cpu")),
            "serve": {"dense": rng.normal(size=(8, cfg.n_dense)).astype(np.float32),
                      "sparse": (rng.random((8, cfg.n_sparse, hot)) * sizes[None, :, None]).astype(np.int32)},
            "retrieval": {"dense": rng.normal(size=(1, cfg.n_dense)).astype(np.float32),
                          "sparse": (rng.random((1, cfg.n_sparse, hot)) * sizes[None, :, None]).astype(np.int32),
                          "candidates": rng.normal(size=(512, cfg.embed_dim)).astype(np.float32)},
        }
    graphs = {}
    for arch in GNN_ARCHS:
        cfg = registry.get_arch(arch).smoke()
        batch = {k: v.numpy() for k, v in gnn_common.gnn_smoke_batch(arch == "gcn-cora", seed=3,
                                                                    device="cpu").items()}
        graphs[arch] = {"params": _tree(gnn.INIT_FNS[arch](cfg, seed=0, device="cpu")), "batch": batch,
                        "masked": dict(batch, edge_mask=np.arange(batch["edge_mask"].shape[0]) % 3 != 0)}
    n_species = registry.get_arch("equiformer-v2").smoke().n_species
    # edges among the first 200 nodes, so that some nodes have several
    big = {"species": rng.integers(0, n_species, BIG_NODES).astype(np.int32),
           "positions": (rng.random((BIG_NODES, 3)) * 4.0).astype(np.float32),
           "node_mask": np.ones(BIG_NODES, dtype=bool),
           "edge_src": rng.integers(0, 200, BIG_EDGES).astype(np.int32),
           "edge_dst": rng.integers(0, 200, BIG_EDGES).astype(np.int32),
           "edge_mask": np.arange(BIG_EDGES) % 5 != 0}
    return {"bags": bags, "dlrm": models, "gnn": graphs, "big": big}


@contextlib.contextmanager
def _rows_rule(module):
    """Shard the tables of more than SHARD_ABOVE_ROWS rows (``module``'s
    ``embedding_placement``, which its ``table_modes`` reads)."""
    real = module.embedding_placement
    module.embedding_placement = lambda rows, *a, **k: types.SimpleNamespace(
        mode="shard" if rows > SHARD_ABOVE_ROWS else "replicate")
    try:
        yield
    finally:
        module.embedding_placement = real


# ---------------------------------------------------------------------------
# the cases, per rank or on one card
# ---------------------------------------------------------------------------


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np_out(x):
    if isinstance(x, torch.Tensor):
        return _numpy(x.detach().contiguous())
    return tuple(_np_out(v) for v in x)


def _model_cases(inputs: dict, mesh) -> dict:
    """Every model case on ``mesh`` (``None``: one card): each result as
    numpy, and each B6 call's lookups on a rank."""
    rules = shd.Rules.from_mesh(mesh)
    m, n_model = (collectives.axis_index(mesh, "model"), rules.model_size) if mesh is not None else (0, 1)
    out = {}
    calls = []
    real_local = dlrm.embedding_bag_local

    def counted(table, idx, bags, n):
        calls.append((int(idx.shape[0]), int(idx.max()) if idx.numel() else -1, int(table.shape[0])))
        return real_local(table, idx, bags, n)

    dlrm.embedding_bag_local = counted
    try:
        with shd.use_mesh(mesh):
            for key, (table, idx) in inputs["bags"].items():
                calls.clear()
                shard = interop.table_row_shard_from_numpy(table, m, n_model, "cpu")
                got = dlrm.embedding_bag_sharded(shard, _t(idx), rules)
                out["bag", *key] = (_np_out(got), collectives.batch_block(rules, idx.shape[0])[:2], list(calls))
            with _rows_rule(dlrm):
                for hot, case in inputs["dlrm"].items():
                    cfg = _dlrm_cfg(hot)
                    params = interop.dlrm_params_from_numpy(case["params"], "cpu")
                    mine = dlrm.shard_params(cfg, rules, params, 8)
                    by_interop = {k: interop.table_row_shard_from_numpy(case["params"]["tables"][k], m, n_model,
                                                                        "cpu")
                                  for k, t in mine["tables"].items() if t is not params["tables"][k]}
                    out["modes", hot] = cfg.table_modes(1 if mesh is None else mesh.size(), 8)
                    out["shards_agree", hot] = (sorted(by_interop), all(
                        torch.equal(mine["tables"][k].view(torch.int16), t.view(torch.int16))
                        for k, t in by_interop.items()))
                    calls.clear()
                    serve = dlrm.make_serve_step(cfg, rules)(mine, {k: _t(v) for k, v in case["serve"].items()})
                    out["serve", hot] = (_np_out(serve), list(calls))
                    rb = {k: _t(v) for k, v in case["retrieval"].items()}
                    out["retrieval", hot] = _np_out(dlrm.make_retrieval_step(cfg, rules)(mine, rb))
                    if mesh is None:  # every candidate's score, for ties
                        q = dlrm._mlp_apply(params["bot"], rb["dense"])[0]
                        embs = [e[0].float() for e in dlrm.embedding_bags(cfg, rules, params, rb["sparse"])]
                        out["all_scores", hot] = _np_out(rb["candidates"] @ torch.stack([q] + embs).mean(0))
    finally:
        dlrm.embedding_bag_local = real_local
    with shd.use_mesh(mesh):
        for arch, case in inputs["gnn"].items():
            cfg = registry.get_arch(arch).smoke()
            params = interop.gnn_params_from_numpy(case["params"], "cpu")
            for masked in (False, True):
                batch = {k: _t(v) for k, v in case["masked" if masked else "batch"].items()}
                out["gnn", arch, masked] = _np_out(gnn.make_gnn_serve_step(cfg, rules)(params, batch))
        b = {k: _t(v) for k, v in inputs["gnn"]["gcn-cora"]["masked"].items()}
        src, dst, emask = gnn.edge_block(rules, b["edge_src"], b["edge_dst"], b["edge_mask"])
        ones = emask.to(torch.float32)[:, None]
        n = b["node_feat"].shape[0]
        out["degrees"] = _np_out((gnn.scatter_sum(ones, gnn.sort_edges(dst), n, rules),
                                  gnn.scatter_sum(ones, gnn.sort_edges(src), n, rules)))
        out["edges_held"] = int(src.shape[0])
        cfg = registry.get_arch("equiformer-v2").smoke()
        params = interop.gnn_params_from_numpy(inputs["gnn"]["equiformer-v2"]["params"], "cpu")
        calls.clear()
        real_big = gnn.equiformer_energy_big
        gnn.equiformer_energy_big = lambda *a: calls.append("big") or real_big(*a)
        try:
            out["big"] = (_np_out(gnn.equiformer_energy(cfg, rules, params, {k: _t(v) for k, v in inputs["big"].items()})),
                          list(calls))
        finally:
            gnn.equiformer_energy_big = real_big
        if mesh is None:  # the large-graph path's own function, plain, on one card
            big = {k: _t(v) for k, v in inputs["big"].items()}
            out["big_plain"] = _np_out(gnn.equiformer_atoms_big_plain(cfg, params, big).sum()[None])
    return out


def _rank_program(rank: int, world: int, store: str, in_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    ranks.init_rank(rank, world, store, device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    try:
        meshes = {s: DeviceMesh("cpu", torch.arange(s[0] * s[1]).reshape(s), mesh_dim_names=("data", "model"))
                  for s in SHAPES}
        with open(in_path, "rb") as f:
            inputs = pickle.load(f)
        res = {}
        for shape, mesh in meshes.items():
            if mesh.get_coordinate() is not None:
                collectives.WIRE_COUNTERS.clear()
                res[shape] = _model_cases(inputs, mesh)
                res[shape]["coord"] = tuple(mesh.get_coordinate())
                res[shape]["wire"] = dict(collectives.WIRE_COUNTERS)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inputs_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_models")
    path = d / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(_inputs(), f)
    return path


@pytest.fixture(scope="module")
def inputs(inputs_path):
    with open(inputs_path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def spawned(inputs_path, repro_8_devices):
    """Every rank's results by mesh, from one spawn (``repro``'s 8-device
    run starts first and runs beside it)."""
    d = inputs_path.parent
    ranks.run_ranks(_rank_program, WORLD, (WORLD, str(d / "store"), str(inputs_path), str(d)),
                    timeout_s=SPAWN_TIMEOUT_S, device="cpu")
    out = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def one_card(inputs):
    return _model_cases(inputs, None)


def _ranks_of(spawned, shape):
    return [r[shape] for r in spawned if shape in r]


def _bits(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def _close(got, want, tol: float, what) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30), what


def _tol(dtype: str, hot: int) -> float:
    return 0.0 if hot == 1 else (2e-2 if dtype == "bf16" else 1e-6)


def _step_tol(hot: int) -> float:
    """The DLRM steps' tolerance: f32 MLPs over bf16 bags that round apart at ``multi_hot`` > 1."""
    return 1e-6 if hot == 1 else 2e-2


# ---------------------------------------------------------------------------
# against the one-card run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_row_sharded_bags_equal_one_card(spawned, one_card, inputs, shape):
    """Each rank's block of bags equals the one-card bags' rows: bit for
    bit at ``multi_hot`` 1, within 1e-6 (f32) or 2e-2 (bf16) at 3; each
    B6 call gets only the rank's lookups in its rows, re-based to its
    shard, and a model axis's ranks share every lookup of a block."""
    n_data, n_model = shape
    k = -(-BAG_ROWS // n_model)
    for key, (table, idx) in inputs["bags"].items():
        dtype, b, hot = key
        want = one_card["bag", *key][0]
        got_by_rank = _ranks_of(spawned, shape)
        per_block = {}
        for r in got_by_rank:
            got, (lo, hi), calls = r["bag", *key]
            assert (hi - lo) == (b // n_data if b % n_data == 0 else b)
            if hot == 1:
                assert _bits(got) == _bits(want[lo:hi]), (shape, key)
            else:
                _close(got, want[lo:hi], _tol(dtype, hot), (shape, key))
            d, m = r["coord"]
            flat = idx[lo:hi].reshape(-1)
            mine = int(((flat >= m * k) & (flat < (m + 1) * k)).sum())
            (n_lookups, most, rows), = calls
            assert (n_lookups, rows) == (mine, k) and most < k
            per_block[lo, hi, d] = per_block.get((lo, hi, d), 0) + n_lookups
        # the model axis's ranks of one block share its lookups, each once
        assert all(v == (hi - lo) * hot for (lo, hi, _), v in per_block.items()), (shape, key)


@pytest.mark.parametrize("hot", HOTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_dlrm_steps_equal_one_card(spawned, one_card, shape, hot):
    """The serve step's probabilities within 1e-6 of the largest (2e-2 at
    ``multi_hot`` 3) and the retrieval's top 64 (scores as close, indices
    equal up to ties) on every rank; the rank's shards cut by ``shard_params`` are the ones
    ``interop`` cuts from the numpy tables; one B6 call a table."""
    want_p, _ = one_card["serve", hot]
    want_s, want_i = one_card["retrieval", hot]
    for r in _ranks_of(spawned, shape):
        assert r["modes", hot] == ["shard", "shard", "replicate"]
        names, agree = r["shards_agree", hot]
        assert agree and names == (["t0", "t1"] if shape[1] > 1 else [])
        probs, calls = r["serve", hot]
        _close(probs, want_p, _step_tol(hot), (shape, hot))
        assert len(calls) == 3
        scores, idx = r["retrieval", hot]
        _close(scores, want_s, _step_tol(hot), (shape, hot))
        _same_up_to_ties(idx, want_i, one_card["all_scores", hot], _step_tol(hot))


def _same_up_to_ties(idx, want_idx, all_scores, tol: float) -> None:
    """Top-k indices equal but where they tie: a differing index scores
    what the one ranked there scores, within ``tol`` of the largest."""
    differ = idx != want_idx
    assert np.abs(all_scores[idx[differ]] - all_scores[want_idx[differ]]).max(initial=0.0) <= (
        tol * np.abs(all_scores).max())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", GNN_ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_gnn_forwards_equal_one_card(spawned, one_card, shape, arch, masked):
    """Each GNN's outputs on edges sharded over every rank, within 1e-5 of
    the largest (EquiformerV2 1e-4), the same on every rank."""
    want = one_card["gnn", arch, masked]
    tol = 1e-4 if arch == "equiformer-v2" else 1e-5
    got = [r["gnn", arch, masked] for r in _ranks_of(spawned, shape)]
    for g in got:
        _close(g, want, tol, (shape, arch, masked))
        assert _bits(g) == _bits(got[0])


@pytest.mark.parametrize("shape", SHAPES)
def test_gcn_degrees_exact_and_big_equiformer_raises(spawned, one_card, shape):
    """GCN's in- and out-degrees over ranks are the one-card degrees bit
    for bit; each rank scatters its block of the edges; and at 150,000
    nodes ``equiformer_energy`` takes ``equiformer_energy_big``, as
    ``repro``'s does on a mesh with a model axis (the one-card run keeps
    the small-graph branch), whose energy is the same on every rank and
    within BIG_TOL of its plain twin's on one card
    (``equiformer_atoms_big_plain``)."""
    got = []
    for r in _ranks_of(spawned, shape):
        for g, want in zip(r["degrees"], one_card["degrees"]):
            assert _bits(g) == _bits(want)
        assert r["edges_held"] == 64 // (shape[0] * shape[1])
        energy, calls = r["big"]
        assert calls == ["big"] and energy.shape == (1,) and np.isfinite(energy).all()
        _close(energy, one_card["big_plain"], BIG_TOL, shape)
        got.append(_bits(energy))
        assert r["wire"]["all_reduces"] > 0
    assert one_card["big"][1] == [] and len(set(got)) == 1


# ---------------------------------------------------------------------------
# against repro on 8 forced host devices
# ---------------------------------------------------------------------------

REPRO_SCRIPT = textwrap.dedent(
    """
    import dataclasses, os, pickle, sys, types
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.configs import dlrm_mlperf, registry
    from repro.dist import compat
    from repro.dist import sharding as shd
    from repro.models import dlrm, gnn

    assert len(jax.devices()) == 8
    with open(sys.argv[1], "rb") as f:
        inputs = pickle.load(f)
    mesh = compat.make_mesh((4, 2), ("data", "model"))
    rules = shd.Rules.from_mesh(mesh)
    dlrm.embedding_placement = lambda rows, *a, **k: types.SimpleNamespace(
        mode="shard" if rows > SHARD_ABOVE_ROWS else "replicate")
    tree = lambda t: jax.tree.map(jnp.asarray, t)
    out = {}
    with shd.use_mesh(mesh):  # each program jitted under the mesh, as repro's steps run
        bag = jax.jit(lambda t, i: dlrm.embedding_bag_sharded(t, i, rules))
        for key, (table, idx) in inputs["bags"].items():
            out["bag", *key] = np.asarray(bag(jnp.asarray(table), jnp.asarray(idx)))
        for hot, case in inputs["dlrm"].items():
            cfg = dataclasses.replace(dlrm_mlperf.smoke(), multi_hot=hot)
            params = tree(case["params"])
            out["serve", hot] = np.asarray(jax.jit(dlrm.make_serve_step(cfg, rules))(params, tree(case["serve"])))
            s, i = jax.jit(dlrm.make_retrieval_step(cfg, rules))(params, tree(case["retrieval"]))
            out["retrieval", hot] = (np.asarray(s), np.asarray(i))
        for arch, case in inputs["gnn"].items():
            step = jax.jit(gnn.make_gnn_serve_step(registry.get_arch(arch).smoke(), rules))
            for masked in (False, True):
                batch = tree(case["masked" if masked else "batch"])
                out["gnn", arch, masked] = np.asarray(step(tree(case["params"]), batch))
        big = jax.jit(gnn.make_gnn_serve_step(registry.get_arch("equiformer-v2").smoke(), rules))
        out["big"] = np.asarray(big(tree(inputs["gnn"]["equiformer-v2"]["params"]), tree(inputs["big"])))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
    """
).replace("SHARD_ABOVE_ROWS", str(SHARD_ABOVE_ROWS))
REPRO_TIMEOUT_S = 240
CHILD_ENV = {**{k: os.environ[k] for k in ("HOME", "PATH", "TMPDIR") if k in os.environ},
             "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}


@pytest.fixture(scope="module")
def repro_8_devices(inputs_path):
    """``repro_8_devices()``: ``repro``'s mesh programs on a (4, 2) mesh
    of 8 forced host devices, from a subprocess started when the fixture
    is made and waited for (at most ``REPRO_TIMEOUT_S``) on first use."""
    d = inputs_path.parent
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(d / "repro.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", REPRO_SCRIPT, str(inputs_path), str(d / "repro.pkl")],
                                stdout=log, stderr=subprocess.STDOUT, env=CHILD_ENV, cwd=cwd)
    cache = []

    def get():
        if not cache:
            try:
                rc = proc.wait(timeout=REPRO_TIMEOUT_S)
            finally:
                proc.kill()
            assert rc == 0, f"repro's 8-device run failed:\n{(d / 'repro.log').read_text()}"
            with open(d / "repro.pkl", "rb") as f:
                cache.append(pickle.load(f))
        return cache[0]

    yield get
    proc.kill()
    proc.wait()


@pytest.mark.parametrize("shape", SHAPES)
def test_ranks_equal_repro_on_8_devices(repro_8_devices, spawned, one_card, inputs, shape):
    """``repro``'s row-sharded bags (bit for bit at ``multi_hot`` 1), its
    serve probabilities and retrieval scores, its four GNN forwards and
    its EquiformerV2 energy at 150,000 nodes (``equiformer_energy_big``)
    on a (4, 2) mesh against every rank, at the tolerances above."""
    want = repro_8_devices()
    all_scores = {hot: one_card["all_scores", hot] for hot in HOTS}
    for r in _ranks_of(spawned, shape):
        for key in inputs["bags"]:
            got, (lo, hi), _ = r["bag", *key]
            w = want["bag", *key][lo:hi]
            if key[2] == 1:
                assert _bits(got) == _bits(w), (shape, key)
            else:
                _close(got, w, _tol(key[0], key[2]), (shape, key))
        for hot in HOTS:
            _close(r["serve", hot][0], want["serve", hot], _step_tol(hot), (shape, hot))
            _close(r["retrieval", hot][0], want["retrieval", hot][0], _step_tol(hot), (shape, hot))
            _same_up_to_ties(r["retrieval", hot][1], np.asarray(want["retrieval", hot][1]), all_scores[hot],
                             _step_tol(hot))
        for arch in GNN_ARCHS:
            for masked in (False, True):
                _close(r["gnn", arch, masked], want["gnn", arch, masked],
                       1e-4 if arch == "equiformer-v2" else 1e-5, (shape, arch, masked))
        _close(r["big"][0], want["big"], BIG_TOL, (shape, "big"))
