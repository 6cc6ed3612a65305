"""The Granite 4.0-H hybrid's plain reference against the program, and its
cell run tiny on the CPU: the benchmark's weights laid out as the program
takes them at full size, the configuration's own keys agreeing with the
published ones beside them, the forward, prefill then decode, and the
training loss and gradients in float32 against the reference; a tiny
cell of the family through ``bench.run``, held to the real cell's
limits, reading ``correct`` true, and false under the fp8 control and
under two planted faults: the decode state zeroed after prefill, and the
state the scan carries from one chunk to the next zeroed."""
import json
import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import gpubench_tiny as tiny
from gpubench import bench, weights
from gpubench.drivers.program import port_config
from gpubench.reference import inputs
from gpubench.reference.layers import Precision
from gpubench.work import granite_hybrid as work

NAME = "granite-4.0-h-micro"
CELL = "granite-4.0-h-micro.decode_2k"
#: the family at a tiny size: 4 layers (attention at layer 1), SSD chunks
#: of 8 so that a prompt spans several. The embedding's multiplier is 1:
#: 8 branches at 0.22 cannot outweigh a 12-fold embedding as the 80 of the
#: published depth do, and each position's best logit would be its own
#: token's (the reference's ``OUT_SCALE``)
SMALL = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
             vocab=256, n_layers=4, hybrid={"attn_layers": [1]},
             embedding_multiplier=1.0)
SERVE = dict(tiny.SERVE, prompt_len=24, decode_tokens=6)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def full_config() -> dict:
    return json.loads((tiny.ROOT / "gpubench" / "configs" / f"{NAME}.json")
                      .read_text())


def tiny_config(**over) -> dict:
    c = full_config()
    c.update(SMALL, name="tiny-granite", **over)
    c["ssm"] = dict(c["ssm"], d_state=16, head_dim=16, chunk_size=8)
    return c


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout's benchmark files with the tiny granite cell, held to
    the real cell's limits and reporting what the real cell reports."""
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    g = root / "gpubench"
    (g / "configs" / "tiny-granite.json").write_text(json.dumps(
        tiny_config()))
    (g / "traffic" / "tiny-granite-serve.json").write_text(json.dumps(SERVE))
    shutil.copy(g / "limits" / f"{CELL}.json",
                g / "limits" / "tiny-granite.serve.json")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "tiny-granite.serve",
                             "config": "tiny-granite",
                             "traffic": "tiny-granite-serve", "chips": 1,
                             "why": "test"})
    for m in doc["end_to_end"] + doc["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny-granite.serve")
    (root / "BENCHMARK.json").write_text(json.dumps(doc, indent=1))
    return root


def test_the_weights_are_laid_out_as_the_program_takes_them():
    from repro_torch.models import model as M
    config = full_config()
    specs = bench.family(config).param_specs(config)
    ours = {"/".join(k): (s.shape, weights.DTYPES[s.dtype])
            for k, s in weights._leaves(specs)}
    theirs = {k: (tuple(t.shape), t.dtype)
              for k, t in weights.leaves(M.abstract_params(
                  port_config(config)))}
    assert ours == theirs


def test_the_programs_keys_say_what_the_published_ones_say():
    c = full_config()
    s = c["ssm"]
    attn = [i for i, t in enumerate(c["layer_types"]) if t == "attention"]
    assert c["hybrid"]["attn_layers"] == attn == [5, 15, 25, 35]
    pairs = [("n_layers", "num_hidden_layers"), ("d_model", "hidden_size"),
             ("n_heads", "num_attention_heads"),
             ("n_kv_heads", "num_key_value_heads"),
             ("d_ff", "shared_intermediate_size"), ("d_ff", "intermediate_size"),
             ("vocab", "vocab_size"), ("norm_eps", "rms_norm_eps"),
             ("tie_embeddings", "tie_word_embeddings")]
    assert all(c[a] == c[b] for a, b in pairs), pairs
    assert (s["d_state"], s["d_conv"], s["expand"], s["head_dim"],
            s["n_groups"]) == (c["mamba_d_state"], c["mamba_d_conv"],
                               c["mamba_expand"], c["mamba_d_head"],
                               c["mamba_n_groups"])
    assert s["expand"] * c["d_model"] // s["head_dim"] == c["mamba_n_heads"]
    assert c["head_dim"] * c["n_heads"] == c["hidden_size"]
    assert c["pos_emb"] == "none" and c["position_embedding_type"] == "nope"
    assert c["hidden_act"] == c["act"] == "silu"
    assert c["reduced"] == [] and c["family"] == "granite_hybrid"
    cfg = port_config(c)
    assert (cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.attention_multiplier, cfg.logits_scaling) == (12, 0.22,
                                                              1 / 64, 8)


def _tokens(seed, n, length, vocab=256):
    return torch.from_numpy(np.stack([inputs.prompt(seed, i, vocab, length)
                                      for i in range(n)]))


def test_reference_forward_equals_the_programs():
    from repro_torch.models import model as M
    config = tiny_config(dtype="float32")
    fam = bench.family(config)
    params = weights.make(fam.param_specs(config), 11, "cpu")
    toks = _tokens(3, 2, 30)
    ref = fam.forward(config, params, toks, Precision("float32"))
    got, _ = M.forward(port_config(config), params, toks)
    assert torch.allclose(got.float(), ref, rtol=1e-4, atol=1e-4)


def test_reference_follows_prefill_and_decode():
    """The program's prefill over three SSD chunks and its decode steps
    through the cache give the logits the reference gives from the whole
    sequence."""
    from repro_torch.models import model as M
    config = tiny_config(dtype="float32")
    cfg = port_config(config)
    fam = bench.family(config)
    params = weights.make(fam.param_specs(config), 12, "cpu")
    toks = _tokens(4, 2, 28)
    ref = fam.forward(config, params, toks, Precision("float32"),
                      keep_from=21)
    with torch.no_grad():
        logits, cache = M.prefill(cfg, params, toks[:, :22], max_len=32)
        got = [logits[:, -1]]
        for t in range(22, 28):
            logits, cache = M.decode_step(cfg, params, cache,
                                          toks[:, t:t + 1].int())
            got.append(logits[:, -1])
    got = torch.stack(got, dim=1).float()
    assert torch.allclose(got, ref, rtol=1e-4, atol=1e-4)


#: the published depth, pattern and embedding multiplier (x 12) at the tiny
#: widths: there the 80 branches outweigh the embedding, as at full size
DEEP = dict(n_layers=40, hybrid={"attn_layers": [5, 15, 25, 35]},
            embedding_multiplier=12.0)


def test_the_published_embedding_multiplier_follows_the_reference():
    """At the published depth and embedding multiplier the program's
    forward, and its prefill then decode steps, give the reference's
    logits; the layers decide them (most positions' best logit is not
    their own token's)."""
    from repro_torch.models import model as M
    config = tiny_config(dtype="float32", **DEEP)
    cfg = port_config(config)
    assert cfg.embedding_multiplier == 12.0
    fam = bench.family(config)
    params = weights.make(fam.param_specs(config), 15, "cpu")
    toks = _tokens(7, 2, 28)
    ref = fam.forward(config, params, toks, Precision("float32"))
    assert (ref.argmax(-1) == toks).float().mean() < 0.5
    with torch.no_grad():
        got, _ = M.forward(cfg, params, toks)
        assert torch.allclose(got.float(), ref, rtol=1e-4, atol=1e-4)
        logits, cache = M.prefill(cfg, params, toks[:, :22], max_len=32)
        steps = [logits[:, -1]]
        for t in range(22, 27):
            logits, cache = M.decode_step(cfg, params, cache,
                                          toks[:, t:t + 1].int())
            steps.append(logits[:, -1])
    steps = torch.stack(steps, dim=1).float()
    assert torch.allclose(steps, ref[:, 21:27], rtol=1e-4, atol=1e-4)


def test_reference_scan_does_not_depend_on_its_chunk():
    config = tiny_config(dtype="float32")
    fam = bench.family(config)
    params = weights.make(fam.param_specs(config), 13, "cpu")
    toks = _tokens(5, 1, 30)
    a = fam.forward(config, params, toks, Precision("float32"))
    other = dict(config, ssm=dict(config["ssm"], chunk_size=5))
    b = fam.forward(other, params, toks, Precision("float32"))
    assert torch.allclose(a, b, rtol=1e-4, atol=1e-4)


def test_training_loss_and_gradients_equal_the_references():
    """The program's chunk gradient step (the trainer's, each layer
    recomputed) against autograd through the reference, in float32."""
    from repro_torch.train.train_step import grad_step
    config = tiny_config(dtype="float32")
    fam = bench.family(config)
    params = weights.make(fam.param_specs(config), 14, "cpu")
    ex = [inputs.example(6, i, 256, 20) for i in range(3)]
    toks = torch.from_numpy(np.stack([e["tokens"] for e in ex])).long()
    labels = torch.from_numpy(np.stack([e["labels"] for e in ex])).long()
    flat = dict(weights.leaves(params))
    live = {k: t.detach().clone().requires_grad_() for k, t in flat.items()}

    def tree(like, path=""):
        if isinstance(like, dict):
            return {k: tree(v, f"{path}/{k}" if path else k)
                    for k, v in like.items()}
        return live[path]

    logits = fam.forward(config, tree(params), toks, Precision("float32"),
                         remat=True)
    loss = F.cross_entropy(logits.reshape(-1, 256), labels.reshape(-1))
    ref = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
    grads, metrics = grad_step(port_config(config), params, {
        "tokens": toks, "labels": labels,
        "loss_mask": torch.ones(labels.shape)})
    assert float(metrics["loss"].detach()) == pytest.approx(loss.item(),
                                                           rel=1e-5)
    got = dict(weights.leaves(grads))
    assert got.keys() == ref.keys()
    for k, g in ref.items():
        assert torch.allclose(got[k], g, rtol=1e-3,
                              atol=1e-5 * float(g.abs().max()) + 1e-9), k


def test_the_work_counts_each_launch():
    c = full_config()
    k = work.serve_kernels(c, 128, 2048, 256)
    assert (len(k["k1"]), len(k["k2"]), len(k["k3"])) == (4, 255 * 4, 36)
    assert k["k3"][0] == (work.cost.ssd_flops(128, 2048, 64, 64, 128, 128),
                          work.cost.ssd_bytes(128, 2048, 64, 64, 1, 128,
                                              False))
    # the model FLOPs: about 2 x 3.19e9 a token (the tied unembedding's
    # counted once a logit row), and attention and the scan beside them
    per_token = work.forward_flops(c, 1, 1, 0, 1)
    assert 6.3e9 < per_token < 6.6e9
    assert work.serve_flops(c, 2, 16, 3) > work.serve_flops(c, 2, 16, 2)


def test_a_tiny_cell_runs_and_is_correct(root):
    line = tiny.run_cpu(root, "tiny-granite.serve", trace=True)
    assert line["correct"], line["checks"]
    m = line["metrics"]
    cfg = port_config(tiny_config())
    from repro_torch.models import model as M
    want = M.cache_bytes(cfg, 4, 32)
    assert m["state_gib.serve"]["value"] == pytest.approx(
        (want["ssm_state"] + want["conv"]) / 2 ** 30)
    assert {"prefill_ms.serve", "decode_step_ms.serve"} <= set(m)


def zero_the_decode_state(monkeypatch):
    from repro_torch.models import granite_hybrid
    prefill = granite_hybrid.prefill

    def patched(*a, **kw):
        logits, cache = prefill(*a, **kw)
        cache["ssm_state"].zero_()
        return logits, cache
    monkeypatch.setattr(granite_hybrid, "prefill", patched)


def zero_the_state_between_chunks(monkeypatch):
    """Each chunk of the scan run from a zero state: nothing carried."""
    from repro_torch.kernels import ops
    scan = ops.ssd_bshn

    def patched(x, dt, A, B, C, *, chunk=128, init_state=None):
        ys, state = [], None
        for t0 in range(0, x.shape[1], chunk):
            part = slice(t0, t0 + chunk)
            y, state = scan(x[:, part], dt[:, part], A, B[:, part],
                            C[:, part], chunk=chunk)
            ys.append(y)
        return torch.cat(ys, 1), state
    monkeypatch.setattr(ops, "ssd_bshn", patched)


FAULTS = [zero_the_decode_state, zero_the_state_between_chunks]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_fault_reads_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    line = tiny.run_cpu(root, "tiny-granite.serve")
    assert not line["correct"], line["checks"]


def test_the_fp8_control_reads_not_correct(root):
    from gpubench import control
    spec = bench.Benchmark(root)
    c = spec.cell("tiny-granite.serve")
    config, mix, limits = spec.config(c), spec.mix(c), spec.limits(c)
    drv = bench.driver_class(mix)(config, mix, 9, torch.device("cpu"))
    got = control.serve_readings(drv, 9, True)
    assert control.judged(got, limits, 9), got
    assert got["program"]["correct"]
    assert not got["control_fp8"]["correct"]
