"""The port's examples (``examples/torch/``) on the CPU.

``overhead_analysis.py`` runs the deterministic simulator and must print,
line for line, what the JAX package's ``examples/overhead_analysis.py``
prints. ``quickstart.py`` sleeps instead of computing; the model examples
run with ``--device cpu`` (a few steps of training) and keep their own
assertions, and without a card their default ``--device cuda`` is an
error, never a fall-back to the CPU.
"""
import importlib.util
import tempfile
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def tmp_tempdir(tmp_path, monkeypatch):
    """The examples' ``tempfile.mkdtemp`` directories land in tmp_path."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def _load(rel: str):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "example_" + rel.replace("/", "_").removesuffix(".py"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_overhead_analysis_prints_the_reference_table(capsys):
    _load("examples/overhead_analysis.py").main()
    ref = capsys.readouterr().out
    _load("examples/torch/overhead_analysis.py").main()
    port = capsys.readouterr().out
    assert len(ref.splitlines()) == 41
    assert port.splitlines() == ref.splitlines()


def test_quickstart_prints_its_split_and_ledger(capsys):
    res = _load("examples/torch/quickstart.py").main()
    out = capsys.readouterr().out
    assert res.iterations == 20_000
    assert sum(res.per_group_items.values()) == 20_000
    assert set(res.per_group_items) == {"accel", "cpu0", "cpu1"}
    for key in ("split:", "accel overheads", "O_kl", "chunk search:",
                "-> G = 512", "EDP", "attributed: team-a"):
        assert key in out, key


def test_serve_hetero_on_the_cpu(capsys):
    rep = _load("examples/torch/serve_hetero.py").main(["--device", "cpu"])
    assert rep.requests == 48 and rep.new_tokens == 288
    assert sum(rep.per_group_items.values()) == 48
    assert sorted(rep.tokens_out) == list(range(48))
    assert "accel offload overheads" in capsys.readouterr().out


def test_observe_on_the_cpu(capsys, tmp_tempdir):
    rep, snap = _load("examples/torch/observe.py").main(["--device", "cpu"])
    assert rep.jobs == rep.done == 50
    assert rep.new_tokens == 50 * 2 * 6
    assert any(k.startswith("sched.chunks") for k in snap["counters"])
    out = capsys.readouterr().out
    assert "last is final=True" in out and str(tmp_tempdir) in out
    (exported,) = tmp_tempdir.glob("repro-observe-*")
    assert {p.name for p in exported.iterdir()} \
        == {"metrics.jsonl", "trace.json", "prom.txt"}


def test_train_hetero_lm_on_the_cpu(capsys, tmp_tempdir):
    """20 steps: the example asserts that the loss falls and writes a
    checkpoint at step 20 (``Checkpointer.save_async``)."""
    tr = _load("examples/torch/train_hetero_lm.py").main(
        ["--device", "cpu", "--steps", "20"])
    assert len(tr.history) == 20
    assert all(sum(r.per_group_items.values()) == 32 for r in tr.history)
    assert tr.history[-1].loss < tr.history[0].loss
    (ckdir,) = tmp_tempdir.glob("hetero_ck_*")
    assert [p.name for p in ckdir.iterdir()] == ["step_20"]
    assert "tuned accelerator chunk G" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["serve_hetero", "observe",
                                  "train_hetero_lm"])
def test_model_examples_need_the_card_by_default(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        _load(f"examples/torch/{name}.py").main([])
    assert e.value.code == 2
