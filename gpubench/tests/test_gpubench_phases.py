"""The per-layer metrics that read the program's phase spans: a traced
tiny run on the CPU reads all five, an untraced run leaves them out, and
a program whose reports carry no phases gives them nothing to read. On
the CPU the program's host stamps stand in for the device's clock."""
from types import SimpleNamespace

import pytest
import torch

import gpubench_tiny as tiny
from gpubench import phases

SERVE = ("prefill_ms.serve", "decode_step_ms.serve")
TRAIN = ("grad_ms.train", "combine_ms.train", "update_ms.train")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell,names,absent", [
    ("tiny-dense.serve", SERVE, TRAIN), ("tiny-dense.train", TRAIN, SERVE)])
def test_a_traced_run_reads_its_phase_metrics(root, cell, names, absent):
    line = tiny.run_cpu(root, cell, trace=True)
    assert line["correct"], line["checks"]
    for name in names:
        m = line["metrics"][name]
        assert m["unit"] == "ms" and m["value"] > 0, name
    assert not set(absent) & set(line["metrics"])


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_an_untraced_run_leaves_them_out(root, cell):
    line = tiny.run_cpu(root, cell)
    assert not set(SERVE + TRAIN) & set(line["metrics"])


def ctx_of(kind, reports):
    return SimpleNamespace(
        driver=SimpleNamespace(kind=kind),
        calls=[SimpleNamespace(report=r) for r in reports])


def phase(device_s, count, steps=0):
    return {"device_s": device_s, "host_s": device_s + 1.0, "count": count,
            "steps": steps}


def test_device_ms_divides_the_window_by_its_count():
    reports = [SimpleNamespace(phases={"a": phase(0.2, 2, 10),
                                       "b": phase(0.1, 1)}),
               SimpleNamespace(phases={"a": phase(0.4, 2, 30),
                                       "b": phase(0.3, 1)})]
    ctx = ctx_of("serve", reports)
    assert phases.device_ms(ctx, "serve", ["a"], "count") \
        == pytest.approx(150.0)
    assert phases.device_ms(ctx, "serve", ["a"], "steps") \
        == pytest.approx(15.0)
    assert phases.device_ms(ctx, "serve", ["a", "b"], "calls") \
        == pytest.approx(500.0)
    assert phases.device_ms(ctx, "train", ["a"], "count") is None
    assert phases.device_ms(ctx, "serve", ["c"], "count") is None


@pytest.mark.parametrize("report", [SimpleNamespace(),
                                    SimpleNamespace(phases={})])
def test_no_phases_nothing_to_read(report):
    """A report of a program with no phase spans (or with telemetry
    off)."""
    assert phases.device_ms(ctx_of("train", [report]), "train",
                            ["train.grad"], "count") is None
