"""The ``granite_hybrid`` family (granite-4.0-h-micro): a layer pattern of
Mamba-2 and GQA attention mixers, each layer with its own MLP, and muP
multipliers. The JAX package has no counterpart, so the port is held to
itself here (prefill and decode through the cache against the whole
forward, the abstract trees against the materialised ones, serving and
training through the normal entry points); the benchmark's plain reference
holds it from outside (``gpubench/tests/test_gpubench_granite_hybrid.py``).
The ``gpu`` case runs the SSD-scan kernel at the configuration's (P, N) =
(64, 128) on the card:

    python -m pytest -m gpu tests/test_torch_granite_hybrid.py
"""
import math

import pytest
import torch
import torch.nn.functional as F

from repro_torch import telemetry as telemetry_mod
from repro_torch.configs.registry import (PORT_ONLY, dryrun_cells,
                                          get_config, get_reduced_config,
                                          list_archs)
from repro_torch.core.types import DeviceKind
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.models import granite_hybrid as granite
from repro_torch.models import model as M
from repro_torch.serve.engine import GroupDef, HeteroServeEngine
from repro_torch.train import optimizer as TO
from repro_torch.train.trainer import GroupDef as TrainGroup
from repro_torch.train.trainer import HeteroTrainer

ARCH = "granite-4.0-h-micro"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _reduced(**kw):
    return get_reduced_config(ARCH).replace(dtype="float32", **kw)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    return {prefix: (tuple(tree.shape), tree.dtype)}


def test_the_arch_resolves_outside_the_dry_run_matrix():
    cfg = get_config(ARCH)
    assert ARCH in PORT_ONLY and ARCH not in list_archs()
    assert all(c.arch_id != ARCH for c, _, _, _ in dryrun_cells())
    assert cfg.family == "granite_hybrid"
    assert granite.layout(cfg).count(("attn", 0)) == 1
    assert [i for i, (kind, _) in enumerate(granite.layout(cfg))
            if kind == "attn"] == [5, 15, 25, 35]


def test_param_count_is_the_abstract_trees():
    cfg = get_config(ARCH)
    n = sum(math.prod(s) for s, _ in _leaves(M.abstract_params(cfg))
            .values())
    assert cfg.param_count() == n
    assert 3.15e9 < n < 3.25e9


def test_cache_bytes_by_kind_at_full_width():
    """One chunk of 128 at 4096 positions: the fp32 states of the 36
    Mamba-2 layers, the bf16 K/V of the 4 attention layers, the conv
    windows."""
    cfg = get_config(ARCH)
    got = M.cache_bytes(cfg, 128, 4096)
    assert got == {"kv": 2 * 4 * 128 * 4096 * 8 * 64 * 2,
                   "ssm_state": 36 * 128 * 64 * 64 * 128 * 4,
                   "conv": 36 * 128 * 3 * (4096 + 2 * 128) * 2}
    dense = M.cache_bytes(get_config("stablelm-1.6b"), 2, 16)
    assert dense["ssm_state"] == dense["conv"] == 0 and dense["kv"] > 0


def test_abstract_trees_describe_what_the_port_materialises():
    cfg = get_reduced_config(ARCH)
    real = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _leaves(M.abstract_params(cfg)) == _leaves(real)
    assert _leaves(M.init_cache(cfg, 3, 32, torch.device("meta"))) \
        == _leaves(M.init_cache(cfg, 3, 32, "cpu"))
    assert set(M.cache_axes(cfg)) == set(M.init_cache(cfg, 3, 32, "cpu"))
    assert set(M.param_axes(cfg)) == set(real)


@pytest.mark.parametrize("attn_layers", [(1,), (0, 3), ()],
                         ids=["one", "first-and-last", "none"])
def test_prefill_and_decode_follow_the_forward(attn_layers):
    """A prompt over three SSD chunks (16 each, the last ragged), then
    decode steps through the cache, give the logits of the whole forward
    at each position."""
    from repro_torch.configs.base import HybridConfig
    cfg = _reduced(hybrid=HybridConfig(attn_layers=attn_layers))
    params = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 46),
                         generator=torch.Generator().manual_seed(2))
    full, _ = M.forward(cfg, params, toks)
    with torch.no_grad():
        logits, cache = M.prefill(cfg, params, toks[:, :40], max_len=64)
        got = [logits[:, -1]]
        for t in range(40, 46):
            logits, cache = M.decode_step(cfg, params, cache,
                                          toks[:, t:t + 1].int())
            got.append(logits[:, -1])
    torch.testing.assert_close(torch.stack(got, 1), full[:, 39:],
                               rtol=1e-4, atol=1e-4)
    assert int(cache["pos"][0]) == 46


def test_the_multipliers_act_where_granite_puts_them():
    """The embedding's, the residual's, the softmax's and the logits'
    multipliers each change the logits, and at 1 (0 for the softmax: 1 /
    sqrt(head_dim)) they are the plain model's."""
    cfg = _reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.randint(0, cfg.vocab, (1, 12),
                         generator=torch.Generator().manual_seed(4))
    base = cfg.replace(embedding_multiplier=1.0, residual_multiplier=1.0,
                       attention_multiplier=0.0, logits_scaling=1.0)
    plain, _ = M.forward(base, params, toks)
    same, _ = M.forward(base.replace(
        attention_multiplier=1 / math.sqrt(cfg.resolved_head_dim)),
        params, toks)
    torch.testing.assert_close(same, plain, rtol=1e-5, atol=1e-5)
    for field, value in (("embedding_multiplier", 12.0),
                         ("residual_multiplier", 0.22),
                         ("attention_multiplier", 1 / 64),
                         ("logits_scaling", 8.0)):
        moved, _ = M.forward(base.replace(**{field: value}), params, toks)
        assert not torch.allclose(moved, plain, rtol=1e-3, atol=1e-3), field
    scaled, _ = M.forward(base.replace(logits_scaling=8.0), params, toks)
    torch.testing.assert_close(scaled * 8.0, plain, rtol=1e-5, atol=1e-5)


def test_serve_gives_the_greedy_tokens_and_counts_the_cache():
    """The engine on the CPU: every request's tokens are the greedy
    continuation of the whole forward; the report and the trace carry each
    chunk's cache bytes by kind."""
    cfg = get_reduced_config(ARCH)
    tel = telemetry_mod.Telemetry()
    eng = HeteroServeEngine(
        cfg, [GroupDef("accel", DeviceKind.ACCEL, device="cpu",
                       fixed_chunk=4)],
        prompt_len=20, decode_tokens=4, seed=5, telemetry=tel)
    rep = eng.serve(6)                     # chunks of 4 and 2
    assert sorted(rep.tokens_out) == list(range(6))
    assert rep.cache_bytes == M.cache_bytes(cfg, 4, eng.max_len)
    assert rep.cache_bytes["ssm_state"] > 0 and rep.cache_bytes["kv"] > 0
    params = eng._params[torch.device("cpu")]
    for i in (0, 5):
        seq = torch.from_numpy(eng._prompt(i)).long()[None]
        want = []
        with torch.no_grad():
            for _ in range(4):
                logits, _ = M.forward(cfg, params, seq)
                nxt = logits[:, -1].argmax(-1, keepdim=True)
                want.append(int(nxt))
                seq = torch.cat([seq, nxt], 1)
        assert rep.tokens_out[i].tolist() == want, i
    events = [e for e in tel.tracer.chrome_events()
              if e["name"] == "serve.cache_bytes"]
    assert sorted(e["args"]["bucket"] for e in events) == [2, 4]
    assert {k: events[0]["args"][k] for k in ("kv", "ssm_state", "conv")} \
        == M.cache_bytes(cfg, events[0]["args"]["bucket"], eng.max_len)


def test_a_training_step_through_the_trainer():
    """``HeteroTrainer`` on the CPU: the step's loss is the forward's
    cross entropy at the starting weights, and every weight moves."""
    cfg = get_reduced_config(ARCH).replace(dtype="float32")
    tr = HeteroTrainer(
        cfg, [TrainGroup("accel", DeviceKind.ACCEL, device="cpu",
                         fixed_chunk=4)],
        seq_len=24, global_batch=8, seed=6,
        oc=TO.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    start = {k: t.detach().clone()
             for k, t in zip(*_flat(tr.opt["master"]))}
    batch = tr.data.batch(0, 8)
    with torch.no_grad():
        logits, _ = M.forward(cfg, tr.opt["master"],
                              torch.from_numpy(batch["tokens"]).long())
        want = F.cross_entropy(logits.reshape(-1, cfg.vocab),
                               torch.from_numpy(batch["labels"]).long()
                               .reshape(-1))
    rep = tr.train_step()
    assert rep.loss == pytest.approx(float(want), rel=1e-4)
    moved = {k: not torch.equal(t, start[k])
             for k, t in zip(*_flat(tr.opt["master"]))}
    assert all(moved.values()), [k for k, v in moved.items() if not v]


def _flat(tree, prefix=""):
    keys, vals = [], []
    for k, v in tree.items():
        if isinstance(v, dict):
            ks, vs = _flat(v, f"{prefix}{k}/")
            keys += ks
            vals += vs
        else:
            keys.append(prefix + k)
            vals.append(v)
    return keys, vals


@pytest.mark.gpu
def test_ssd_scan_kernel_at_state_128_matches_plain():
    """K3 at (P, N) = (64, 128), granite's: ragged lengths (1000 and 37 at
    chunk 128, 300 at 64), a seeded state, B/C groups shared by heads; x,
    B and C column slices of one conv output whose rows past s hold NaN.
    Tolerance as for the other instantiations: max |diff| <= 2e-2 of max
    |y| and of max |state|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    blocks, smem = SSD.occupancy(64, 128, dev)
    assert blocks >= 1 and smem <= 227 * 1024
    for b, s, nh, g, chunk, with_init in [(2, 1000, 4, 1, 128, True),
                                          (3, 37, 8, 2, 128, False),
                                          (1, 300, 8, 1, 64, True)]:
        P, N, pad = 64, 128, 5
        conv = (rnd(b, s + pad, nh * P + 2 * g * N) * 0.5).to(torch.bfloat16)
        conv[:, s:] = float("nan")
        x = conv[:, :s, :nh * P].unflatten(-1, (nh, P))
        B = conv[:, :s, nh * P:nh * P + g * N].unflatten(-1, (g, N))
        C = conv[:, :s, nh * P + g * N:].unflatten(-1, (g, N))
        dt = F.softplus(rnd(b, s, nh))
        A = -torch.exp(rnd(nh) * 0.3)
        init = rnd(b, nh, P, N) if with_init else None
        y, state = SSD.ssd_scan(x, dt, A, B, C, chunk, init)
        torch.cuda.synchronize()
        ey, estate = SSD.ssd_scan_plain(x, dt, A, B, C, chunk, init)
        assert bool(torch.isfinite(y).all()) and bool(
            torch.isfinite(state).all())
        for got, exp in ((y.float(), ey.float()), (state, estate)):
            err = (got - exp).abs().max().item()
            assert err <= 2e-2 * exp.abs().max().item(), (b, s, g, err)
