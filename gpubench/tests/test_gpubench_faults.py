"""A run with the timed path broken underneath reads ``correct`` false, for
each fault its cell can have: an answer altered where it is produced, half
of a call's answers left out, a training step that leaves its state
unchanged, and half of each batch left out of the gradient. The cells are
tiny and run on the CPU, held to the real cells' limits; a run with no
fault reads ``correct`` true."""
import pytest
import torch

import gpubench_tiny as tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def alter_a_token(monkeypatch):
    from repro_torch.serve.engine import HeteroServeEngine
    make = HeteroServeEngine._make_executor

    def patched(self, g, key=None):
        ex = make(self, g, key)
        step = ex.step

        def altered(batch):
            toks = step(batch).clone()
            toks[:, 2] = (toks[:, 2] + 1) % self.cfg.vocab
            return toks
        ex.step = altered
        return ex
    monkeypatch.setattr(HeteroServeEngine, "_make_executor", patched)


def drop_half_the_answers(monkeypatch):
    from repro_torch.serve.engine import HeteroServeEngine
    serve = HeteroServeEngine.serve

    def patched(self, n):
        rep = serve(self, n)
        rep.tokens_out = {i: t for i, t in rep.tokens_out.items()
                          if i < n // 2}
        return rep
    monkeypatch.setattr(HeteroServeEngine, "serve", patched)


def leave_the_state_unchanged(monkeypatch):
    from repro_torch.train import trainer
    monkeypatch.setattr(trainer, "adamw_update",
                        lambda oc, params, grads, opt: (params, opt, {}))


def drop_half_the_batch(monkeypatch):
    from repro_torch.data.pipeline import SyntheticLMData
    batch = SyntheticLMData.batch

    def patched(self, begin, end, pad_to=None):
        out = batch(self, begin, end, pad_to)
        out["loss_mask"] = out["loss_mask"].copy()
        out["loss_mask"][(end - begin) // 2:] = 0.0
        return out
    monkeypatch.setattr(SyntheticLMData, "batch", patched)


FAULTS = [("tiny-dense.serve", alter_a_token),
          ("tiny-dense.serve", drop_half_the_answers),
          ("tiny-dense.train", leave_the_state_unchanged),
          ("tiny-dense.train", drop_half_the_batch)]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_a_sound_run_is_correct(root, cell):
    line = tiny.run_cpu(root, cell)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_fault_reads_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    line = tiny.run_cpu(root, cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_the_fp8_control_reads_not_correct(root, cell):
    """``gpubench/control.py``'s readings, judged under the cell's limits
    as a run is: the program's read correct; the control's (the reference
    computed in fp8 in the program's place) and, for training, the planted
    fault's (half of each batch left out) read not correct."""
    from gpubench import bench, control
    spec = bench.Benchmark(root)
    c = spec.cell(cell)
    config, mix, limits = spec.config(c), spec.mix(c), spec.limits(c)
    drv = bench.driver_class(mix)(config, mix, 9, torch.device("cpu"))
    read = control.serve_readings if drv.kind == "serve" \
        else control.train_readings
    got = read(drv, 9, True)
    assert control.judged(got, limits, 9), got
    assert got["program"]["correct"]
    assert not got["control_fp8"]["correct"]
    if drv.kind == "train":
        assert not got["fault_half_batch"]["correct"]
