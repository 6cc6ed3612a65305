"""Each family's plain reference against the program's CPU path on a tiny
preset in float32, the benchmark's weights laid out as the program takes
them at full size, and the training reference against the program's
trainer."""
import json

import numpy as np
import pytest
import torch

import gpubench_tiny as tiny
from gpubench import bench, weights
from gpubench.drivers.program import port_config
from gpubench.reference import inputs
from gpubench.reference.layers import Precision


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


FAMILIES = [("stablelm-1.6b", "tiny-dense")]


def shapes(tree):
    return {k: (tuple(t.shape), t.dtype) for k, t in weights.leaves(tree)}


@pytest.mark.parametrize("name", ["stablelm-1.6b"])
def test_the_weights_are_laid_out_as_the_program_takes_them(name):
    from repro_torch.models import model as M
    config = json.loads((tiny.ROOT / "gpubench" / "configs" / f"{name}.json")
                        .read_text())
    specs = bench.family(config).param_specs(config)
    ours = {k: (s.shape, weights.DTYPES[s.dtype])
            for k, s in weights._leaves(specs)
            for k in ["/".join(k)]}
    assert ours == shapes(M.abstract_params(port_config(config)))


@pytest.mark.parametrize("src,name", FAMILIES)
def test_reference_forward_equals_the_programs(src, name):
    from repro_torch.models import model as M
    config = tiny.tiny_config(src, name, dtype="float32")
    fam = bench.family(config)
    params = weights.make(fam.param_specs(config), 11, "cpu")
    toks = torch.from_numpy(np.stack([inputs.prompt(3, i, config["vocab"],
                                                    24) for i in range(2)]))
    ref = fam.forward(config, params, toks, Precision("float32"))
    got, _ = M.forward(port_config(config), params, toks)
    assert torch.allclose(got.float(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("src,name", FAMILIES)
def test_reference_follows_prefill_and_decode(src, name):
    """The program's prefill and decode steps through its cache give the
    logits the reference gives from the whole sequence."""
    from repro_torch.models import model as M
    config = tiny.tiny_config(src, name, dtype="float32")
    cfg = port_config(config)
    fam = bench.family(config)
    params = weights.make(fam.param_specs(config), 12, "cpu")
    toks = torch.from_numpy(np.stack([inputs.prompt(4, i, config["vocab"],
                                                    20) for i in range(2)]))
    ref = fam.forward(config, params, toks, Precision("float32"),
                      keep_from=15)
    with torch.no_grad():
        logits, cache = M.prefill(cfg, params, toks[:, :16], max_len=32)
        got = [logits[:, -1]]
        for t in range(16, 20):
            logits, cache = M.decode_step(cfg, params, cache,
                                          toks[:, t:t + 1].int())
            got.append(logits[:, -1])
    got = torch.stack(got, dim=1).float()
    assert torch.allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_the_fp8_control_differs_from_float32():
    config = tiny.tiny_config("stablelm-1.6b", "tiny-dense",
                              dtype="float32")
    fam = bench.family(config)
    params = weights.make(fam.param_specs(config), 13, "cpu")
    toks = torch.from_numpy(inputs.prompt(5, 0, config["vocab"], 16))[None]
    a = fam.forward(config, params, toks, Precision("float32"))
    b = fam.forward(config, params, toks, Precision("fp8"))
    gap = (a - b).abs().max() / a.abs().max()
    assert 1e-3 < gap < 0.5


def test_training_reference_equals_the_programs_trainer(tmp_path):
    """The whole tiny training cell in float32: the program's three steps
    read as the reference's to rounding."""
    root = tiny.make_root(tmp_path)
    cfg = root / "gpubench" / "configs" / "tiny-dense.json"
    c = json.loads(cfg.read_text())
    cfg.write_text(json.dumps(dict(c, dtype="float32")))
    line = tiny.run_cpu(root, "tiny-dense.train")
    for k, v in line["checks"].items():
        assert v["value"] < 1e-4, (k, v)
    assert line["correct"]


def test_inputs_are_the_programs():
    """The frozen prompt and example generators give what the program's
    engine and data pipeline give."""
    from repro_torch.data.pipeline import for_model
    from repro_torch.serve.engine import HeteroServeEngine
    config = tiny.tiny_config("stablelm-1.6b", "tiny-dense")
    cfg = port_config(config)
    eng = HeteroServeEngine.__new__(HeteroServeEngine)
    eng.seed, eng.cfg, eng.prompt_len = 2 ** 33 + 5, cfg, 12
    for i in (0, 7):
        assert np.array_equal(eng._prompt(i),
                              inputs.prompt(2 ** 33 + 5, i, 256, 12))
    data = for_model(cfg, 10, 2 ** 33 + 5)
    for i in (0, 9):
        ours = inputs.example(2 ** 33 + 5, i, 256, 10)
        theirs = data.sample(i)
        assert all(np.array_equal(ours[k], theirs[k]) for k in ours)
