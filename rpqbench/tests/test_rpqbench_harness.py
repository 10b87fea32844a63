"""The harness: its files load, its names keep to the contract, a cell
added as files alone is found, no run loads JAX, and a run on the CPU at
a small size is correct, and not correct under each fault of its timed
path or with the control in the program's place."""

import json
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from rpqbench import bench, check, traffic
from rpqbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_rpqbench_harness_cells_load(cell):
    c = bench.load_cell(ROOT, cell)
    assert c.chips == 1 and c.config["name"] in cell and "window" in c.mix
    assert callable(c.source.requests) and callable(c.client.drive) and callable(c.client.warmup)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "rpq_per_s"}
    assert c.per_layer, "every cell reports a per-layer metric"


def test_rpqbench_harness_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len({m["name"] for m in metrics}) == len(metrics) and len(set(CELLS)) == len(CELLS)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert 1 <= BENCH["run_seconds"] <= 51 and len(json.dumps(BENCH)) < 64 * 1024


def test_rpqbench_harness_per_layer_files_match_entries():
    for m in BENCH["per_layer"]:
        reader = bench.load_module(ROOT, "metrics", m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES, reader.SOURCE) == \
            (m["unit"], m["layer"], m["moves"], m["source"]), m["name"]


def test_rpqbench_harness_moves_reported_where_listed():
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", CELLS):
            reported = [e["name"] for e in bench.load_cell(ROOT, cell).end_to_end]
            assert m["moves"] in reported, (m["name"], cell)


def test_rpqbench_harness_cell_added_as_files(tmp_path):
    """A new configuration, traffic mix and per-layer metric, as new files
    and entries in BENCHMARK.json, with no file of the harness edited."""
    shutil.copytree(ROOT / "rpqbench", tmp_path / "rpqbench", ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads(json.dumps(BENCH))
    conf = json.loads((ROOT / "rpqbench/configs/alibaba256-rows-f32.json").read_text())
    conf.update(name="alibaba64-rows-f32")
    conf["placement"]["n_sites"] = 64
    (tmp_path / "rpqbench/configs/alibaba64-rows-f32.json").write_text(json.dumps(conf))
    mix = {"source": "table2", "client": "sync_windows", "queries": ["q6"], "block": 1, "warmup": 2, "window": 1}
    (tmp_path / "rpqbench/traffic/q6.json").write_text(json.dumps(mix))
    (tmp_path / "rpqbench/metrics/window_requests.py").write_text(
        'UNIT, LAYER, MOVES, SOURCE = "requests", "service", "rpq_per_s", "host_clock"\n\n\n'
        "def read(run):\n    return run.resolved\n")
    b["configs"].append({"name": conf["name"], "source": "x", "file": "rpqbench/configs/alibaba64-rows-f32.json",
                         "reduced": ["n_sites"], "why": "x"})
    b["workloads"].append({"name": "alibaba64-rows-f32.q6", "config": conf["name"], "traffic": "q6", "chips": 1,
                           "why": "x"})
    b["per_layer"].append({"name": "window_requests", "unit": "requests", "better": "higher", "source": "host_clock",
                           "layer": "service", "moves": "rpq_per_s", "workloads": ["alibaba64-rows-f32.q6"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    c = bench.load_cell(tmp_path, "alibaba64-rows-f32.q6")
    assert c.config["placement"]["n_sites"] == 64 and c.mix == mix
    assert [m["name"] for m, _ in c.per_layer] == ["window_requests"]
    assert [m["name"] for m in c.end_to_end] == ["rpq_per_s", "setup_s"]
    assert c.per_layer[0][1].read(bench.RunData(conf, None, 0, "cpu", 7, [])) == 7
    inputs = bench.make_inputs(c.config | {"graph": {"generator": "alibaba_like", "args": {"n_nodes": 4000,
                                                                                            "n_edges": 16000}}})
    warm, stream = traffic.requests(c.mix, c.source, inputs, seed=2**33 + 5)
    assert inputs.reference_s > 0
    assert [q for q, _ in warm] == [bench.generators.TABLE2_QUERIES["q6"]] * 2 and len(next(stream)[1]) == 2


def test_rpqbench_harness_loads_no_jax():
    """What a run imports, the port's modules with it, loads no module of
    jax, jaxlib, flax or repro (compared by whole top-level names)."""
    code = (
        "import importlib.util, sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        f"spec = importlib.util.spec_from_file_location('rpqbench_run', {str(ROOT / 'rpqbench/run.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import rpqbench.bench, rpqbench.check, rpqbench.reference.bfs, rpqbench.trace, rpqbench.roofline\n"
        "import repro_torch.serve, repro_torch.core.strategies, repro_torch.kernels.frontier.ops\n"
        "from rpqbench import bench\n"
        "print(bench.forbidden_modules(), len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("]")[0] == "[", out.stdout


def test_rpqbench_harness_exits_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, str(ROOT / "rpqbench/run.py"), "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def shrink(c: bench.Cell) -> bench.Cell:
    """A cell's configuration cut for the CPU: a 5,000-node twin on 16
    sites, 20 rollouts a plan."""
    c.config["graph"]["args"].update(n_nodes=5000, n_edges=25000)
    c.config["placement"]["n_sites"] = 16
    c.config["serve"]["n_rollouts"] = 20
    return c


STREAM = {"source": "seed_paths", "client": "sync_windows", "block": 16, "warmup": 16, "window": 16,
          "stream": {"n_queries": 400, "min_len": 2, "max_len": 4, "wildcard_prob": 0.1, "union_prob": 0.2,
                     "closure_prob": 0.15, "hot_fraction": 0.8, "hot_pool": 8, "min_starts": 1, "max_starts": 8,
                     "seed": 0}}


def small(mix: str = "table2") -> bench.Cell:
    """The f32 cell shrunk for the CPU, on a small Table-2 mix
    (four whole queries a pass) or on the port's seed-path stream (400
    requests; the mix of the stream cell that PERF.md keeps for later)."""
    c = shrink(bench.load_cell(ROOT, "alibaba256-rows-f32.table2"))
    if mix == "table2":
        c.mix.update(queries=["q1", "q6", "q11", "q2"], block=4, warmup=4, window=2)
    else:
        c.mix = json.loads(json.dumps(STREAM))
        c.source = bench.load_module(ROOT, "sources", c.mix["source"])
    return c


def run_small(mix: str = "table2", seed: int = 2**31 + 11):
    return bench.run(small(mix), seed, 1.0, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("mix", ["table2", "stream"])
def test_rpqbench_harness_run_on_cpu_is_correct(mix):
    result, checks = run_small(mix)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["attempted"] % small(mix).mix["block"] == 0  # the window ends on a whole block
    assert list(result["metrics"]) == ["rpq_per_s", "latency_p95_ms", "setup_s"]  # the cell's end-to-end metrics
    assert checks["meters_gap"]["value"] < checks["meters_gap"]["limit"]


def test_rpqbench_harness_source_and_client_added_as_files(tmp_path):
    """A request source, a client loop and a mix that uses both with its
    own ``enqueue`` arguments, as new files alone, drive a run."""
    shutil.copytree(ROOT / "rpqbench", tmp_path / "rpqbench", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "rpqbench/sources/listed.py").write_text(
        "import numpy as np\n\n\n"
        "def requests(mix, inputs):\n"
        "    return [(q, np.array(s, np.int32)) for q, s in mix['requests']]\n")
    (tmp_path / "rpqbench/clients/one_at_a_time.py").write_text(
        "def check(mix):\n    pass\n\n\n"
        "def warmup(svc, reqs, mix):\n    for q, s in reqs:\n        svc.submit(q, s, **mix['enqueue'])\n\n\n"
        "def drive(svc, stream, mix, seconds, clock):\n"
        "    done, flushes, t0 = [], [], clock()\n"
        "    while clock() - t0 < seconds:\n"
        "        q, s = next(stream)\n"
        "        t = clock()\n"
        "        ticket = svc.enqueue(q, s, **mix['enqueue'])\n"
        "        svc.flush()\n"
        "        flushes.append((clock() - t, len(done), 1))\n"
        "        done.append((q, s, ticket))\n"
        "    return done, flushes\n")
    mix = {"source": "listed", "client": "one_at_a_time", "enqueue": {"strategy": "S2"}, "block": 2, "warmup": 2,
           "window": 1, "requests": []}
    (tmp_path / "rpqbench/traffic/listed.json").write_text(json.dumps(mix))
    b = json.loads(json.dumps(BENCH))
    b["workloads"].append({"name": "alibaba256-rows-f32.listed", "config": "alibaba256-rows-f32",
                           "traffic": "listed", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    c = shrink(bench.load_cell(tmp_path, "alibaba256-rows-f32.listed"))
    assert c.source.__file__.startswith(str(tmp_path)) and c.client.__file__.startswith(str(tmp_path))
    labels = bench.make_inputs(c.config).graph.labels
    c.mix["requests"] = [[f"{labels[0]} ({labels[1]})*", [0, 1, 2]], [f"({labels[2]}|{labels[3]}) .", [5, 7]]]
    result, checks = bench.run(c, 2**32 + 9, 0.5, False, "cpu", time.perf_counter())
    assert result["correct"], checks
    assert result["attempted"] > 0


def _unchanged_state(monkeypatch):
    from repro_torch.kernels.frontier import ops

    monkeypatch.setattr(ops.LevelLoop, "run", lambda self, state: state)


def _half_batch(monkeypatch):
    from repro_torch.core import strategies

    real = strategies.s2_execute

    def half(*args, **kwargs):  # every second row of the batch (padding follows the real rows)
        acc, costs = real(*args, **kwargs)[:2]
        acc = np.array(acc)
        acc[1::2] = False
        zero = strategies.StrategyCost("S2", 0.0, 0.0)
        return acc, [c if i % 2 == 0 else zero for i, c in enumerate(costs)]

    monkeypatch.setattr(strategies, "s2_execute", half)


def _answer_altered(monkeypatch):
    from repro_torch.core import strategies

    real = strategies.s2_execute

    def altered(*args, **kwargs):
        acc, costs = real(*args, **kwargs)[:2]
        acc = np.array(acc)
        acc[0, (int(np.asarray(args[2])[0]) + 1) % acc.shape[1]] ^= True
        return acc, costs

    monkeypatch.setattr(strategies, "s2_execute", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _answer_altered])
def test_rpqbench_harness_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, checks = run_small()
    assert not result["correct"], checks
    assert checks["answers_wrong"]["value"] > 0 or checks["meters_gap"]["value"] > checks["meters_gap"]["limit"]


def test_rpqbench_harness_control_is_not_correct():
    """The reference, its meters in bfloat16, in the program's place on
    whole Table-2 requests of the small twin: the meters' gap passes the
    limit, the answers are right."""
    c = bench.load_cell(ROOT, "alibaba256-rows-f32.table2")
    c.config["graph"]["args"].update(n_nodes=5000, n_edges=25000)
    c.mix["queries"] = ["q1", "q9", "q12"]
    inputs = bench.make_inputs(c.config)
    warm, _ = traffic.requests(c.mix, c.source, inputs, seed=3)
    checks = check.judge(check.control(warm, inputs.index), inputs.index, c.config["limits"])
    assert checks["answers_wrong"]["value"] == 0 and checks["malformed"]["value"] == 0
    assert checks["meters_gap"]["value"] > checks["meters_gap"]["limit"]


@pytest.mark.gpu
def test_rpqbench_harness_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "rpqbench/run.py", "--workload", "alibaba256-rows-f32.table2",
                          "--seed", str(2**31 + 3), "--seconds", "3", "--trace", "1"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0


def test_rpqbench_harness_idle_time_by_span():
    """Idle time is split over the host spans open across it."""
    import collections

    from rpqbench import trace

    spans = [(0, 10, "window"), (1, 5, "flush"), (2, 3, "plan"), (3.5, 4.5, "s2_execute"), (6, 9, "flush")]
    segs = trace._innermost(spans)
    assert [s[2] for s in segs] == ["window", "flush", "plan", "flush", "s2_execute", "flush", "window", "flush",
                                    "window"]
    idle = collections.Counter()
    trace._spread(segs, [s[0] for s in segs], 2.5, 7.0, "window", idle)
    assert idle == {"plan": 0.5, "flush": 2.0, "s2_execute": 1.0, "window": 1.0}
