"""The serving engine's per-bucket step functions (``_fns_for``) and what
CUDA graphs of them need.

On the CPU: every family's decode step keeps each cache leaf, tensor and
address, from prefill on and advances ``pos`` in place (a replayed graph
reads and writes the cache where it was captured); the port engine's
``_fns_for(b)`` is cached per bucket and its functions match the JAX
engine's ``_fns_for(b)`` on the bridged weights; the launch accounting
that keeps the kernels' counts exact under capture and replay, driven by
a stand-in graph; the caches of K2's split tickets and of the RoPE
tables, which the graphs read at their capture-time addresses, never
drop a tensor. Reduced configs in fp32, tolerance rtol = atol = 2e-5
(tests/test_kernels.py's fp32 one).

Marked ``gpu`` (each skips inside itself without a card): graphed and
eager tokens equal on reduced stablelm-1.6b and zamba2-1.2b in bf16, two
executors on one device capturing at once, and a small bucket's graphs
still right after a larger bucket captured on the same stream. This module imports JAX
only inside the test that compares with the JAX engine, so on the card

    python -m pytest -m gpu tests/test_torch_graphs.py

runs without JAX.
"""
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_reduced_config
from repro_torch.core import DeviceKind
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import launch_count
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import GroupDef, HeteroServeEngine

CPU = torch.device("cpu")
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# (a) the cache keeps its tensors through decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["stablelm-1.6b", "phi-3-vision-4.2b",
                                  "zamba2-1.2b", "granite-moe-1b-a400m",
                                  "xlstm-350m"])
def test_decode_keeps_every_cache_leaf_and_advances_pos_in_place(arch):
    """Prefill and 3 decode steps: the cache is the same dict, every leaf
    the same tensor at the same address, and ``pos`` (the same tensor)
    reads prompt length + steps after each step."""
    cfg = get_reduced_config(arch).replace(dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    rng = np.random.default_rng(1)
    b, s = 2, 16
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s),
                                           dtype=np.int32))
    prefix = torch.from_numpy(
        rng.standard_normal((b, cfg.prefix_len, cfg.d_model))
        .astype(np.float32) * 0.02) if cfg.prefix_len else None
    with torch.no_grad():
        logits, cache = TM.prefill(cfg, params, tokens, prefix,
                                   max_len=32 + cfg.prefix_len)
        leaves = {k: (t, t.data_ptr()) for k, t in cache.items()}
        pos = cache["pos"]
        for step in range(1, 4):
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            logits, out = TM.decode_step(cfg, params, cache, tok)
            assert out is cache
            assert sorted(out) == sorted(leaves)
            for k, (t, ptr) in leaves.items():
                assert out[k] is t and t.data_ptr() == ptr, (arch, k, step)
            assert torch.equal(pos, torch.full((b,), s + cfg.prefix_len
                                               + step, dtype=torch.int32))
            assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# (b) _fns_for against the JAX engine's
# ---------------------------------------------------------------------------

def test_fns_for_is_cached_per_bucket_and_matches_the_jax_engine():
    """Reduced stablelm-1.6b (2 layers, fp32), bucket 4: the port's
    prefill_fn and 4 decode_fn steps against the JAX engine's, each step
    fed the JAX run's greedy token; the engine's executor step then uses
    the same cached pair."""
    import jax

    from repro.configs.registry import get_reduced_config as jax_reduced
    from repro.core.types import DeviceKind as JaxDeviceKind
    from repro.serve.engine import HeteroServeEngine as JaxServeEngine
    from repro.train.trainer import GroupDef as JaxGroupDef
    from repro_torch.bridge import params_from_jax

    cfg_j = jax_reduced("stablelm-1.6b").replace(n_layers=2, dtype="float32")
    cfg_t = get_reduced_config("stablelm-1.6b").replace(n_layers=2,
                                                        dtype="float32")
    b, prompt_len, steps = 4, 16, 4
    jeng = JaxServeEngine(
        cfg_j, [JaxGroupDef("accel", JaxDeviceKind.ACCEL, fixed_chunk=b)],
        prompt_len=prompt_len, decode_tokens=steps + 1)
    params = params_from_jax(cfg_t, jax.tree.map(np.asarray, jeng.params),
                             CPU)
    teng = HeteroServeEngine(
        cfg_t, [GroupDef("accel", DeviceKind.ACCEL, device=CPU,
                         fixed_chunk=b)],
        prompt_len=prompt_len, decode_tokens=steps + 1, params=params)
    fns = teng._fns_for(b)
    assert teng._fns_for(b) is fns and teng._fns_for(2 * b) is not fns
    prompts = np.stack([teng._prompt(i) for i in range(b)])
    np.testing.assert_array_equal(
        prompts, np.stack([jeng._prompt(i) for i in range(b)]))

    j_prefill, j_decode = jeng._fns_for(b)
    t_prefill, t_decode = fns
    jl, jc = j_prefill(jeng.params, prompts, None)
    with torch.no_grad():
        tl, tc = t_prefill(params, torch.from_numpy(prompts), None)
        for step in range(steps + 1):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
            if step == steps:
                break
            tok = np.asarray(jl[:, -1].argmax(-1)[:, None]).astype(np.int32)
            jl, jc = j_decode(jeng.params, jc, tok)
            tl, tc = t_decode(params, tc, torch.from_numpy(tok))

    ex = teng._executor_for(teng.groups[0])
    assert ex.name == "accel" and ex.stream is None
    teng.serve(b)
    assert list(teng._fns) == [(None, b), (None, 2 * b)]
    assert teng.graph_counts.snapshot()["captures"] == 0


# ---------------------------------------------------------------------------
# (c) launch accounting under capture and replay
# ---------------------------------------------------------------------------

class StandInGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def zeroed_launches():
    saved = FA.launches, FD.launches, SSD.launches
    FA.launches = FD.launches = SSD.launches = 0
    yield
    FA.launches, FD.launches, SSD.launches = saved


def test_a_captures_launches_are_taken_back_and_each_replay_adds_them(
        zeroed_launches):
    launch_count.launched("flash_decode")            # an eager launch
    with launch_count.uncounted() as tally:          # a capture
        for _ in range(3):
            launch_count.launched("flash_decode")
        launch_count.launched("flash_attention")
        assert (FA.launches, FD.launches) == (1, 4)  # counted as they go
    assert tally == {"flash_decode": 3, "flash_attention": 1}
    assert (FA.launches, FD.launches, SSD.launches) == (0, 1, 0)
    graph = launch_count.CountedGraph(StandInGraph(), tally)
    tally["ssd_scan"] = 5                            # the graph kept a copy
    for _ in range(2):
        graph.replay()
    assert graph.graph.replays == 2
    assert (FA.launches, FD.launches, SSD.launches) == (2, 7, 0)


def test_a_failed_capture_takes_its_launches_back_too(zeroed_launches):
    with pytest.raises(RuntimeError):
        with launch_count.uncounted():
            launch_count.launched("ssd_scan")
            raise RuntimeError("capture failed")
    assert SSD.launches == 0
    launch_count.launched("ssd_scan")
    assert SSD.launches == 1


def test_launches_on_other_threads_during_a_capture_stay_counted(
        zeroed_launches):
    """Another dispatcher thread's launches and replays while one thread
    captures are neither tallied nor taken back; nested blocks keep their
    own tallies."""
    inside, go = threading.Event(), threading.Event()
    other = launch_count.CountedGraph(StandInGraph(), {"flash_decode": 2})

    def capture():
        with launch_count.uncounted() as tally:
            launch_count.launched("flash_attention")
            inside.set()
            go.wait(5)
            with launch_count.uncounted() as inner:
                launch_count.launched("flash_attention")
            assert inner == {"flash_attention": 1}
        assert tally == {"flash_attention": 1}

    t = threading.Thread(target=capture)
    t.start()
    assert inside.wait(5)
    for _ in range(10):
        launch_count.launched("flash_attention")
        other.replay()
    go.set()
    t.join(5)
    assert not t.is_alive()
    assert (FA.launches, FD.launches) == (10, 20)


def test_split_tickets_and_rope_tables_outlive_every_graph(monkeypatch):
    """A graph reads K2's split tickets and the RoPE table at the addresses
    they had at capture, so neither cache replaces or drops a tensor it
    handed out: a larger bucket on the same stream gets a ticket buffer of
    its own beside the smaller one's, and a RoPE table stays cached after
    40 other (config, device) pairs."""
    monkeypatch.setattr(FD, "_counters", {})
    stream = SimpleNamespace(cuda_stream=1)
    small = FD._tickets(CPU, stream, 2)
    large = FD._tickets(CPU, stream, 16)
    assert large is not small and (small.numel(), large.numel()) == (2, 16)
    assert FD._tickets(CPU, stream, 2) is small
    assert FD._tickets(CPU, stream, 16) is large
    assert FD._tickets(CPU, SimpleNamespace(cuda_stream=2), 2) is not small
    assert len(FD._counters) == 3
    cfg = get_reduced_config("stablelm-1.6b")
    table = TT._rope(cfg, CPU)[0]
    for i in range(40):
        TT._rope(cfg.replace(rope_theta=cfg.rope_theta + i + 1), CPU)
    assert TT._rope(cfg, CPU)[0] is table


# ---------------------------------------------------------------------------
# (d) on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _eager_tokens(cfg, params, prompts, max_len, decode_tokens):
    with torch.no_grad():
        logits, cache = TM.prefill(cfg, params, prompts, max_len=max_len)
        toks = []
        for step in range(decode_tokens):
            toks.append(logits[:, -1].argmax(-1, keepdim=True)
                        .to(torch.int32))
            if step + 1 < decode_tokens:
                logits, cache = TM.decode_step(cfg, params, cache, toks[-1])
        return torch.cat(toks, 1).cpu().numpy(), logits.float()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "zamba2-1.2b"])
def test_graphed_tokens_equal_eager_on_the_card(arch):
    """Reduced ``arch`` in bf16, one group ``accel:chunk=4:async=2``, 12
    requests (chunks of 4, and bucket 4 once more at the end): the
    engine's tokens equal an eager greedy loop's for every request, one
    capture, 3 x 4 replays, launches exact, the last logits of the
    bucket's graphs bit-equal to eager."""
    dev = _card()
    cfg = get_reduced_config(arch)
    n, prompt_len, decode_tokens = 12, 32, 4
    eng = HeteroServeEngine(
        cfg, [GroupDef("accel", DeviceKind.ACCEL, device=dev, fixed_chunk=4,
                       async_depth=2)],
        prompt_len=prompt_len, decode_tokens=decode_tokens)
    before = {m: m.launches for m in (FA, FD, SSD)}
    rep = eng.serve(n)
    after = {m: m.launches - before[m] for m in (FA, FD, SSD)}
    counts = eng.graph_counts.snapshot()
    chunks = rep.overheads["accel"]["n_chunks"]
    assert counts["captures"] == 1 and counts["failures"] == 0
    assert counts["replays"] == chunks * decode_tokens == 12
    params = eng._params[dev]
    prompts = torch.from_numpy(np.stack([eng._prompt(i) for i in range(n)]))
    for c in range(0, n, 4):
        want, logits = _eager_tokens(cfg, params, prompts[c:c + 4].to(dev),
                                     eng.max_len, decode_tokens)
        for i in range(4):
            np.testing.assert_array_equal(rep.tokens_out[c + i], want[i])
    if cfg.family == "hybrid":
        apps = cfg.n_layers // cfg.hybrid.attn_every
        per = {SSD: cfg.n_layers, FA: apps, FD: apps * (decode_tokens - 1)}
    else:
        per = {SSD: 0, FA: cfg.n_layers,
               FD: cfg.n_layers * (decode_tokens - 1)}
    assert after == {m: chunks * k for m, k in per.items()}
    # the last chunk's logits, replayed through the bucket's graphs
    ex = eng._executor_for(eng.groups[0])
    prefill_fn, decode_fn = eng._fns_for(4, ex)
    with torch.no_grad():
        logits, cache = prefill_fn(params, prompts[-4:].to(dev), None)
        for step in range(decode_tokens - 1):
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            logits, cache = decode_fn(params, cache, tok)
        assert torch.equal(logits.float(), _eager_tokens(
            cfg, params, prompts[-4:].to(dev), eng.max_len,
            decode_tokens)[1])


@pytest.mark.gpu
def test_two_executors_capture_at_once_on_one_device():
    """Two executors of one engine (two namespaces, as two federated
    runtimes) capture bucket 4 in two threads at once, then replay in
    both threads together: each gets the eager tokens, two captures, no
    failure, and every split ticket back at zero."""
    dev = _card()
    cfg = get_reduced_config("stablelm-1.6b")
    eng = HeteroServeEngine(
        cfg, [GroupDef("accel", DeviceKind.ACCEL, device=dev, fixed_chunk=4,
                       async_depth=2)], prompt_len=32, decode_tokens=4)
    params = eng._params[dev]
    prompts = torch.from_numpy(np.stack([eng._prompt(i) for i in range(4)]))
    want, _ = _eager_tokens(cfg, params, prompts.to(dev), eng.max_len, 4)
    got, errors, start = {}, [], threading.Barrier(2)

    def run(ns):
        try:
            ex = eng._executor_for(eng.groups[0], ns)
            start.wait(10)
            prefill_fn, decode_fn = eng._fns_for(4, ex)
            outs = []
            with torch.no_grad(), torch.cuda.stream(ex.stream):
                for _ in range(5):
                    logits, cache = prefill_fn(params, prompts.to(dev), None)
                    toks = []
                    for step in range(4):
                        toks.append(logits[:, -1].argmax(-1, keepdim=True)
                                    .to(torch.int32))
                        if step < 3:
                            logits, cache = decode_fn(params, cache,
                                                      toks[-1])
                    outs.append(torch.cat(toks, 1).cpu().numpy())
            got[ns] = outs
        except BaseException as e:        # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(ns,))
               for ns in ("r0/", "r1/")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    counts = eng.graph_counts.snapshot()
    assert counts["captures"] == 2 and counts["failures"] == 0
    assert counts["replays"] == 2 * 5 * 4
    for outs in got.values():
        for toks in outs:
            np.testing.assert_array_equal(toks, want)
    assert not any(int(t.abs().sum()) for t in FD._counters.values())


@pytest.mark.gpu
def test_a_small_buckets_graphs_keep_their_tickets_after_a_larger_capture():
    """Reduced yi-6b (2 kv heads) with 520-token prompts, so K2 splits the
    1,024-row cache at buckets 1 and 8 alike: one executor captures bucket
    1, then bucket 8; small tensors filled with 7 are then allocated on
    its stream, where a ticket buffer the bucket-1 graphs still read
    would land had it been freed. Replayed, bucket 1 gives the eager
    tokens and bit-equal logits, and every ticket buffer is back at
    zero."""
    dev = _card()
    cfg = get_reduced_config("yi-6b")
    decode_tokens = 4
    eng = HeteroServeEngine(
        cfg, [GroupDef("accel", DeviceKind.ACCEL, device=dev, fixed_chunk=8,
                       async_depth=2)],
        prompt_len=520, decode_tokens=decode_tokens)
    params = eng._params[dev]
    ex = eng._executor_for(eng.groups[0])
    assert FD.split_count(8, cfg.n_kv_heads, eng.max_len,
                          FD._sm_count(dev.index)) > 1
    prefill_fn, decode_fn = eng._fns_for(1, ex)
    eng._fns_for(8, ex)
    for b in (1, 8):
        assert (dev.index, ex.stream.cuda_stream,
                b * cfg.n_kv_heads) in FD._counters
    with torch.cuda.stream(ex.stream):
        junk = [torch.full((n,), 7, dtype=torch.int32, device=dev)
                for n in range(1, 129) for _ in range(4)]
    prompt = torch.from_numpy(eng._prompt(0)[None]).to(dev)
    want, want_logits = _eager_tokens(cfg, params, prompt, eng.max_len,
                                      decode_tokens)
    with torch.no_grad():
        logits, cache = prefill_fn(params, prompt, None)
        toks = []
        for step in range(decode_tokens):
            toks.append(logits[:, -1].argmax(-1, keepdim=True)
                        .to(torch.int32))
            if step + 1 < decode_tokens:
                logits, cache = decode_fn(params, cache, toks[-1])
        got = torch.cat(toks, 1).cpu().numpy()
    np.testing.assert_array_equal(got, want)
    assert torch.equal(logits.float(), want_logits)
    torch.cuda.synchronize(dev)
    assert all(int(t.abs().sum()) == 7 * t.numel() for t in junk)
    assert not any(int(t.abs().sum()) for t in FD._counters.values())
    assert eng.graph_counts.snapshot()["failures"] == 0
