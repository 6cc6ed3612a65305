"""The harness on the card, at the tiny cells' sizes: a whole run of each,
traced, with the power sampled. Needs a CUDA card (the ``gpu`` marker);
skips without one. On the card:

    python -m pytest -m gpu gpubench/tests
"""
import time

import pytest
import torch

import gpubench_tiny as tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_a_traced_run_on_the_card(root, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gpubench import bench
    from gpubench.power import PowerSampler
    line = bench.run(root, cell, 7, 0.5, True, "cuda:0", time.monotonic(),
                     PowerSampler("0"))
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    for m in line["metrics"].values():
        assert m["value"] >= 0
