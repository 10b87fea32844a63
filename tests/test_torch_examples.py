"""The port's example scripts (``examples/torch_*.py``) on the CPU, each
run through its ``main(argv)`` with ``--device cpu``: the quickstart
prints ``repro``'s quickstart's answers; the plan-and-serve driver
checks every answer against the PAA oracle and prints no ``MISMATCH``;
the two training drivers, stopped after a few steps and run again on
their own checkpoints, give the losses of an uninterrupted run bit for
bit.  Each script defaults to ``--device cuda`` and raises without a GPU."""

import contextlib
import importlib.util
import io
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _printed(main, *args) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(*args)
    return out.getvalue()


def test_quickstart_prints_repros_answers():
    got = _printed(_load("torch_quickstart").main, ["--device", "cpu"])
    assert got == _printed(_load("quickstart").main)
    assert "pairs [(1, 5), (1, 8), (2, 7), (9, 5), (9, 8)]" in got


def test_plan_and_serve_answers_match_the_oracle():
    """``--small`` (an 8,000-node twin), q1 and q6, two starts each, cold
    then warm: every start's answers equal the PAA oracle's."""
    out = _printed(_load("torch_plan_and_serve_rpq").main,
                   ["--small", "--queries", "q1,q6", "--device", "cpu"])
    assert "MISMATCH" not in out
    assert out.count("[OK]") == 8
    assert "--- warm replay ---" in out and "cache_hit=True" in out


@pytest.mark.parametrize("script, argv", [
    ("torch_train_gnn", ["--arch", "gcn-cora"]),
    ("torch_train_gnn", ["--arch", "schnet"]),
    ("torch_train_lm", []),
])
def test_training_resumes_from_its_own_checkpoints(tmp_path, script, argv):
    """Four steps at once, against two steps then a rerun to four on the
    same checkpoint folder: the rerun resumes at step 2 and its losses
    are the uninterrupted run's, bit for bit."""
    main = _load(script).main
    whole = main([*argv, "--steps", "4", "--ckpt", str(tmp_path / "whole"), "--device", "cpu"])
    first = main([*argv, "--steps", "2", "--ckpt", str(tmp_path / "resumed"), "--device", "cpu"])
    rest = main([*argv, "--steps", "4", "--ckpt", str(tmp_path / "resumed"), "--device", "cpu"])
    assert (whole.start_step, first.start_step, rest.start_step) == (0, 0, 2)
    assert first.losses + rest.losses == whole.losses
    assert len(whole.losses) == 4 and len(set(whole.losses)) > 1


@pytest.mark.parametrize("script", ["torch_quickstart", "torch_plan_and_serve_rpq", "torch_train_gnn",
                                    "torch_train_lm"])
def test_examples_default_to_the_gpu(monkeypatch, tmp_path, script):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--ckpt", str(tmp_path)] if "train" in script else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(script).main(argv)
