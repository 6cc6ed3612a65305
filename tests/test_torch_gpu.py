"""The CUDA kernels against their plain versions, on a card.

Marked ``gpu``: each test decides inside itself whether there is a CUDA
device and skips without one. The module imports torch and the port only
(no JAX), so it runs on a machine with the card:

    python -m pytest -m gpu tests/test_torch_gpu.py

bf16 inputs; tolerance 2e-2, tests/test_kernels.py's bf16 one (for the
SSD scan relative to the largest output, see its test).
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_attention_bwd as FB
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import launch_count
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.kernels import ssm_state_step as S1


@pytest.mark.gpu
def test_cuda_kernels_match_plain():
    """Ragged lengths, GQA, a q_offset and every head dim group the
    serving path uses; flash-decode never reads past kv_len."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev) \
            .to(torch.bfloat16)

    # the last: stablelm's prefill in a bulk chunk of 64
    for b, sq, h, kvh, d, off in [(2, 100, 4, 2, 16, 0), (2, 64, 8, 8, 64, 0),
                                  (1, 33, 4, 1, 128, 7),
                                  (64, 512, 32, 32, 64, 0)]:
        q, k, v = rnd(b, sq, h, d), rnd(b, sq + off, kvh, d), \
            rnd(b, sq + off, kvh, d)
        out = FA.flash_attention(q, k, v, q_offset=off)
        exp = FA.flash_attention_plain(q, k, v, q_offset=off)
        torch.testing.assert_close(out.float(), exp.float(), rtol=2e-2,
                                   atol=2e-2)
        kv_len = torch.randint(1, sq + 1, (b,), generator=gen, device=dev,
                               dtype=torch.int32)
        out = FD.flash_decode(q[:, :1], k, v, kv_len)
        exp = FD.flash_decode_plain(q[:, :1], k, v, kv_len)
        torch.testing.assert_close(out.float(), exp.float(), rtol=2e-2,
                                   atol=2e-2)
        # the kernel stops at kv_len: rows past it are never read
        poisoned_k, poisoned_v = k.clone(), v.clone()
        for row, n in enumerate(kv_len.tolist()):
            poisoned_k[row, n:] = float("nan")
            poisoned_v[row, n:] = float("nan")
        again = FD.flash_decode(q[:, :1], poisoned_k, poisoned_v, kv_len)
        torch.testing.assert_close(again, out, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128])
def test_flash_attention_every_head_dim_from_fused_qkv(d):
    """Every instantiated head dim, q/k/v sliced from one fused QKV
    projection (sequence stride (h + 2 kvh) d, not copied), GQA 4:1,
    ragged lengths that end inside a kv tile and a q tile, an explicit
    q_offset (a prefill continuing a cache), and full attention; the
    last two at phi3-medium-14b's 40 query heads on 10 kv heads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(d)
    for b, sq, h, kvh, off, causal in [(2, 200, 8, 2, 0, True),
                                       (1, 77, 8, 2, 45, True),
                                       (3, 130, 4, 1, 0, False),
                                       (1, 1, 4, 4, 63, True),
                                       (2, 300, 40, 10, 37, True),
                                       (1, 333, 40, 10, 0, False)]:
        skv = sq + off
        qkv = torch.randn(b, skv, (h + 2 * kvh) * d, generator=gen,
                          device=dev).to(torch.bfloat16)
        q = qkv[:, off:, :h * d].unflatten(-1, (h, d))
        k = qkv[..., h * d:(h + kvh) * d].unflatten(-1, (kvh, d))
        v = qkv[..., (h + kvh) * d:].unflatten(-1, (kvh, d))
        out = FA.flash_attention(q, k, v, causal=causal, q_offset=off)
        exp = FA.flash_attention_plain(q, k, v, causal=causal, q_offset=off)
        assert out.shape == (b, sq, h, d) and out.is_contiguous()
        torch.testing.assert_close(out.float(), exp.float(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("b,S,h,kvh,d", [
    (8, 1024, 32, 32, 96),      # phi-3-vision decode
    (8, 1024, 32, 4, 128),      # yi-6b decode, GQA 8:1
    (1, 1024, 32, 32, 64),      # batch 1: the cache split across blocks
    (64, 1024, 32, 32, 64),     # stablelm's bulk chunk of 64: n_split 1
    (3, 200, 8, 4, 16),         # a short cache, GQA 2:1
])
def test_flash_decode_split_kv(b, S, h, kvh, d):
    """The split-KV kernel at the split count it picks and at forced ones
    (1, 3, 8: every split but the first empty when kv_len = 1), against
    both plain versions, with kv_len in {1, S} and random; rows past
    kv_len hold NaN and are never read; q is a strided slice of a fused
    projection and the caches a layer's slice of a stacked cache. Calls
    back to back give the same result, and leave the merge's tickets at
    zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(d + kvh)
    qkv = torch.randn(b, 1, (h + 2 * kvh) * d, generator=gen,
                      device=dev).to(torch.bfloat16)
    q = qkv[..., :h * d].unflatten(-1, (h, d))
    cache = torch.randn(2, 2, b, S, kvh, d, generator=gen,
                        device=dev).to(torch.bfloat16)
    kc, vc = cache[0, 1], cache[1, 1]
    for kv_len in (torch.ones(b, dtype=torch.int32, device=dev),
                   torch.full((b,), S, dtype=torch.int32, device=dev),
                   torch.randint(1, S + 1, (b,), generator=gen, device=dev,
                                 dtype=torch.int32)):
        exp = FD.flash_decode_plain(q, kc, vc, kv_len)
        poisoned_k, poisoned_v = kc.clone(), vc.clone()
        for row, n in enumerate(kv_len.tolist()):
            poisoned_k[row, n:] = float("nan")
            poisoned_v[row, n:] = float("nan")
        for n_split in (None, 1, 3, 8):
            out = FD.flash_decode(q, kc, vc, kv_len, n_split=n_split)
            again = FD.flash_decode(q, poisoned_k, poisoned_v, kv_len,
                                    n_split=n_split)
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), exp.float(), rtol=2e-2,
                                       atol=2e-2)
            if n_split is not None:
                split = FD.flash_decode_split_plain(q, kc, vc, kv_len,
                                                    n_split)
                torch.testing.assert_close(out.float(), split.float(),
                                           rtol=2e-2, atol=2e-2)
            torch.testing.assert_close(again, out, rtol=0, atol=0)
    # captured in a CUDA graph on a stream whose tickets exist already, a
    # split call replays right: the merging blocks leave them at zero
    eager = FD.flash_decode(q, kc, vc, kv_len, n_split=3)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        FD.flash_decode(q, kc, vc, kv_len, n_split=3)
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        captured = FD.flash_decode(q, kc, vc, kv_len, n_split=3)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(captured, eager, rtol=0, atol=0)
    assert all(int(t.abs().sum()) == 0 for t in FD._counters.values())


@pytest.mark.gpu
def test_ssd_scan_kernel_matches_plain():
    """Both instantiated (P, N) pairs; ragged lengths (13 and 37 at chunk
    16, 1000 at chunk 128), B/C groups shared by heads, a seeded state.
    x, B and C are column slices of one conv output, as the model passes
    them, and the rows past s hold NaN: the kernel never reads them.
    Tolerance: max |diff| <= 2e-2 of max |y| and of max |state|; the
    kernel rounds the same three intermediates to bf16 as the plain
    version (repro/models/ssm.py:111-134) but sums in another order, so a
    weight can round to the neighbouring bf16 value. Chunk 24 is not a
    multiple of the kernel's 16-row tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    for b, s, nh, P, g, N, chunk, with_init in [
            (2, 13, 8, 16, 1, 8, 16, False), (2, 37, 8, 16, 2, 8, 16, True),
            (2, 1000, 4, 64, 1, 64, 128, True),
            (1, 256, 8, 64, 8, 64, 128, False),
            (2, 100, 4, 64, 2, 64, 24, True)]:
        pad = 7
        conv = (rnd(b, s + pad, nh * P + 2 * g * N) * 0.5).to(torch.bfloat16)
        conv[:, s:] = float("nan")
        x = conv[:, :s, :nh * P].unflatten(-1, (nh, P))
        B = conv[:, :s, nh * P:nh * P + g * N].unflatten(-1, (g, N))
        C = conv[:, :s, nh * P + g * N:].unflatten(-1, (g, N))
        dt_full = F.softplus(rnd(b, s + pad, nh))
        dt_full[:, s:] = float("nan")
        dt = dt_full[:, :s]
        A = -torch.exp(rnd(nh) * 0.3)
        init = rnd(b, nh, P, N) if with_init else None
        y, state = SSD.ssd_scan(x, dt, A, B, C, chunk, init)
        torch.cuda.synchronize()
        ey, estate = SSD.ssd_scan_plain(x, dt, A, B, C, chunk, init)
        assert y.shape == ey.shape and state.shape == estate.shape
        assert bool(torch.isfinite(y).all()) and bool(
            torch.isfinite(state).all())
        for got, exp in ((y.float(), ey.float()), (state, estate)):
            err = (got - exp).abs().max().item()
            assert err <= 2e-2 * exp.abs().max().item(), (b, s, g, err)


def _state_step_case(dev, b, nh, P, N, g, seed):
    """A decode state step's inputs as the model passes them, but wider:
    x, B and C column slices of a bf16 conv output with 8 columns more
    (NaN) than they take; the state fp32."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    conv = (rnd(b, nh * P + 2 * g * N + 8) * 0.5).to(torch.bfloat16)
    conv[:, -8:] = float("nan")
    x = conv[:, :nh * P].unflatten(-1, (nh, P))
    B = conv[:, nh * P:nh * P + g * N].unflatten(-1, (g, N))
    C = conv[:, nh * P + g * N:nh * P + 2 * g * N].unflatten(-1, (g, N))
    dt = F.softplus(rnd(b, nh) - 1)
    return x, dt, rnd(nh) * 0.5, B, C, rnd(nh)


@pytest.mark.gpu
@pytest.mark.parametrize("P,N,g", [(64, 128, 1), (64, 64, 1), (64, 128, 2),
                                   (16, 8, 1)])
@pytest.mark.parametrize("layout", ["layers_first", "batch_first"])
def test_ssm_state_step_kernel_matches_plain_in_place(P, N, g, layout):
    """Every instantiated (P, N) and 2 groups at N 128, on x, B and C
    views that are not contiguous (``_state_step_case``) and a state that
    is a layer of a 5-D cache: (layers, b, nh, P, N)[1], as the models
    keep it, or (b, layers, nh, P, N)[:, 1], strided in b. The kernel
    updates that layer in place and leaves the others' bits alone; the
    state is within 1e-6 of max |state| of the plain version's (the same
    fp32 roundings), y within 1e-5 of max |y| (the read-out sums in
    another order). One launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    b, nh = 6, 8
    args = _state_step_case(dev, b, nh, P, N, g, seed=P + N + g)
    gen = torch.Generator(device=dev).manual_seed(9)
    if layout == "layers_first":
        cache = torch.randn(3, b, nh, P, N, generator=gen, device=dev)
        state = cache[1]
    else:
        cache = torch.randn(b, 3, nh, P, N, generator=gen, device=dev)
        state = cache[:, 1]
    before, start = cache.clone(), state.clone()
    launches = S1.launches
    y = S1.ssm_state_step(state, *args)
    torch.cuda.synchronize()
    assert S1.launches == launches + 1
    want_state = start.clone()
    want = S1.ssm_state_step_plain(want_state, *args)
    assert y.shape == (b, nh, P) and y.dtype == torch.float32
    assert bool(torch.isfinite(y).all())
    assert not torch.equal(state, start)
    err_s = (state - want_state).abs().max().item()
    assert err_s <= 1e-6 * want_state.abs().max().item(), err_s
    err_y = (y - want).abs().max().item()
    assert err_y <= 1e-5 * want.abs().max().item(), err_y
    others = torch.ones(cache.shape[:2], dtype=torch.bool)
    others[(1, slice(None)) if layout == "layers_first"
           else (slice(None), 1)] = False
    assert torch.equal(cache[others], before[others])


@pytest.mark.gpu
def test_ssm_state_step_graph_replay_repeats_eager_bits():
    """The wrapper captured in a CUDA graph (it allocates only y, launches
    on the current stream, never synchronises): each replay gives the
    bits of an eager call on the same state, and adds the capture's one
    launch to the count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    args = _state_step_case(dev, 16, 64, 64, 128, 1, seed=3)
    state = torch.randn(16, 64, 64, 128, device=dev)
    eager_state = state.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        S1.ssm_state_step(state.clone(), *args)      # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with launch_count.uncounted() as tally:
        with torch.cuda.graph(graph):
            y = S1.ssm_state_step(state, *args)
    assert tally == {"ssm_state_step": 1}
    counted = launch_count.CountedGraph(graph, tally)
    launches = S1.launches
    for _ in range(3):
        counted.replay()
        want = S1.ssm_state_step(eager_state, *args)
        torch.cuda.synchronize()
        assert torch.equal(y, want) and torch.equal(state, eager_state)
    assert S1.launches == launches + 6


@pytest.mark.gpu
def test_granite_engine_launches_the_state_step_in_every_mamba_layer():
    """granite-4.0-h-micro at full width (36 Mamba-2 layers) served
    through the engine's CUDA graphs, 8 requests in chunks of 4: the state
    step launches 36 x (decode_tokens - 1) times a chunk, K3 36 times a
    chunk, and no capture fails."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs.registry import get_config
    from repro_torch.core import DeviceKind
    from repro_torch.models.granite_hybrid import layout
    from repro_torch.serve.engine import GroupDef, HeteroServeEngine
    dev = torch.device("cuda", 0)
    cfg = get_config("granite-4.0-h-micro")
    n_mamba = sum(kind == "mamba" for kind, _ in layout(cfg))
    assert n_mamba == 36
    decode_tokens = 4
    eng = HeteroServeEngine(
        cfg, [GroupDef("accel", DeviceKind.ACCEL, device=dev, fixed_chunk=4,
                       async_depth=2)],
        prompt_len=32, decode_tokens=decode_tokens, seed=0)
    before = (S1.launches, SSD.launches)
    rep = eng.serve(8)
    after = (S1.launches - before[0], SSD.launches - before[1])
    counts = eng.graph_counts.snapshot()
    chunks = rep.overheads["accel"]["n_chunks"]
    assert chunks == 2 and sorted(rep.tokens_out) == list(range(8))
    assert counts["captures"] == 1 and counts["failures"] == 0
    assert counts["replays"] == chunks * decode_tokens
    assert after == (n_mamba * (decode_tokens - 1) * chunks,
                     n_mamba * chunks)
    del eng
    torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["N 32", "x float32", "state bfloat16"])
def test_ssm_state_step_refuses_on_the_card(what):
    """On CUDA tensors the wrapper raises on a state size it has no
    instantiation for and on dtypes it does not take: there is no
    fallback, and nothing launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    N = 32 if what == "N 32" else 128
    x, dt, A_log, B, C, D = _state_step_case(dev, 2, 4, 64, N, 1, seed=5)
    state = torch.zeros(2, 4, 64, N, device=dev)
    if what == "x float32":
        x = x.float()
    elif what == "state bfloat16":
        state = state.to(torch.bfloat16)
    launches = S1.launches
    with pytest.raises((ValueError, TypeError)):
        S1.ssm_state_step(state, x, dt, A_log, B, C, D)
    assert S1.launches == launches


@pytest.mark.gpu
def test_flash_decode_from_four_threads_counts_exactly():
    """Four threads, each on a stream of its own, call the split-KV
    flash-decode (n_split 4) at once, as four federated dispatchers do:
    ``launches`` counts every call, each output equals a serial call on
    the default stream bit for bit (the merge sums the splits in a fixed
    order), and the merge leaves every stream's tickets at zero."""
    import threading
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    b, S, h, kvh, d, calls = 8, 1024, 32, 4, 128, 200
    inputs = []
    for _ in range(4):
        q = torch.randn(b, 1, h, d, generator=gen, device=dev).bfloat16()
        kc, vc = (torch.randn(b, S, kvh, d, generator=gen,
                              device=dev).bfloat16() for _ in range(2))
        kv_len = torch.randint(1, S + 1, (b,), generator=gen, device=dev,
                               dtype=torch.int32)
        inputs.append((q, kc, vc, kv_len))
    serial = [FD.flash_decode(*args, n_split=4) for args in inputs]
    torch.cuda.synchronize()
    outs = [None] * 4
    errors = []
    barrier = threading.Barrier(4)

    def worker(i):
        try:
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            barrier.wait()
            with torch.cuda.stream(stream):
                for _ in range(calls):
                    outs[i] = FD.flash_decode(*inputs[i], n_split=4)
            stream.synchronize()
        except BaseException as e:      # surfaced below
            errors.append(e)

    before = FD.launches
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    assert FD.launches - before == 4 * calls
    for got, exp in zip(outs, serial):
        torch.testing.assert_close(got, exp, rtol=0, atol=0)
    torch.cuda.synchronize()
    assert all(int(t.abs().sum()) == 0 for t in FD._counters.values())


@pytest.mark.gpu
def test_executor_abort_with_chunks_in_flight_then_reuse():
    """A TorchChunkExecutor three chunks deep aborts while its chunks are
    still queued on its stream (each starts with a ~0.3 s spin kernel):
    none is fetched, abort hands all three back for requeue. Their
    outputs are dropped under the running kernels; new chunks then run on
    the same stream, and each result equals the same step run on the
    default stream, so no memory a queued kernel still wrote was handed to
    a later chunk."""
    from repro_torch.core import (Chunk, ChunkRecord, DeviceKind, Token,
                                  TorchChunkExecutor)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    w = torch.randn(2048, 2048, generator=gen, device=dev).bfloat16() / 45
    spin = [True]

    def step(x):
        if spin[0]:
            torch.cuda._sleep(500_000_000)      # ~0.3 s of device time
        x = x.bfloat16()
        for _ in range(16):
            x = torch.tanh(x @ w)
        return x.sum(-1)

    def make_inputs(token):
        rng = torch.Generator().manual_seed(token.chunk.begin)
        return torch.randn(256, 2048, generator=rng).numpy()

    fetched = []

    def fetch(outs):
        fetched.append(outs.cpu())
        return {"sum": fetched[-1]}

    def run(ex, begin):
        token = Token(Chunk(begin, begin + 1, begin), "accel",
                      DeviceKind.ACCEL)
        return ex.execute(token, ChunkRecord(token))

    ex = TorchChunkExecutor(step, make_inputs, fetch, device=dev,
                            async_depth=4)
    spin[0] = False                 # warm-up: cuBLAS on the stream, and
    for begin in range(3):          # the pinned staging pool
        run(ex, begin)
    ex.drain()
    fetched.clear()
    spin[0] = True
    for begin in range(3):
        assert run(ex, begin) == []
    assert not ex._inflight[0][2].query()       # still queued
    lost = ex.abort()
    assert sorted(c.begin for c in lost) == [0, 1, 2]
    assert fetched == [] and not ex._inflight
    spin[0] = False
    for begin in range(3, 6):
        run(ex, begin)
    done = ex.drain()
    assert [r.token.chunk.begin for r in done] == [3, 4, 5]
    for rec in done:
        x = torch.as_tensor(make_inputs(rec.token)).to(dev)
        torch.testing.assert_close(rec.meta["result"]["sum"],
                                   step(x).cpu(), rtol=0, atol=0)


@pytest.mark.gpu
def test_serve_jobs_federated_two_runtimes_on_the_card():
    """``serve_jobs_federated`` with 2 runtimes on cuda:0, reduced
    stablelm-1.6b in bf16: every job done, both runtimes served, and the
    kernels' launch counts equal the chunks the run counted (one
    flash-attention call a layer per prefill, one flash-decode call a
    layer per decode step)."""
    from repro_torch import telemetry as telemetry_mod
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.core import DeviceKind
    from repro_torch.queue import Job
    from repro_torch.serve.engine import GroupDef, HeteroServeEngine
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg = get_reduced_config("stablelm-1.6b")
    assert cfg.dtype == "bfloat16"
    tel = telemetry_mod.Telemetry()
    eng = HeteroServeEngine(
        cfg, [GroupDef("accel", DeviceKind.ACCEL, device=dev, fixed_chunk=4,
                       async_depth=2)],
        prompt_len=32, decode_tokens=4, telemetry=tel)
    jobs = [Job(items=1, tenant=("a", "b")[i % 2]) for i in range(24)]
    fa0, fd0 = FA.launches, FD.launches
    rep = eng.serve_jobs_federated(jobs, runtimes=2, batch_jobs=4,
                                   timeout_s=120.0)
    assert rep.drained
    assert rep.fed.done == 24 and rep.fed.failed == 0
    assert all(j.state.value == "done" for j in jobs)
    chunks = sum(v for k, v in tel.registry.snapshot()["counters"].items()
                 if k.startswith("sched.chunks"))
    assert chunks >= 24 // 4
    assert FA.launches - fa0 == chunks * cfg.n_layers
    assert FD.launches - fd0 == chunks * cfg.n_layers * 3


@pytest.mark.gpu
def test_moe_fwd_on_the_card_matches_the_cpu_and_repeats_its_bits():
    """``moe_fwd`` on reduced granite-moe in bf16 (4 experts, top-2; 3 x 40
    tokens for a capacity of 80, so experts overflow): the card against
    the CPU on the same bf16 weights and inputs within 2e-2 (the bf16
    tolerance; the router runs in fp32 on both, TF32 off, so both pick the
    same experts), the aux loss within 1e-5; and two runs on the card give
    the same bits: the fp32 combine writes each kept (token, expert) row
    once and sums a token's rows in a fixed order."""
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import init_from_defs
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg = get_reduced_config("granite-moe-1b-a400m")
    assert cfg.dtype == "bfloat16"
    gen = torch.Generator().manual_seed(0)
    p = init_from_defs(MOE.moe_defs(cfg), gen, "cpu")
    x = (torch.randn(3, 40, cfg.d_model, generator=gen)
         + 1.5 * torch.randn(cfg.d_model, generator=gen)).bfloat16()
    out_cpu, aux_cpu = MOE.moe_fwd(cfg, p, x)
    p_dev = {k: v.to(dev) for k, v in p.items()}
    out1, aux1 = MOE.moe_fwd(cfg, p_dev, x.to(dev))
    out2, aux2 = MOE.moe_fwd(cfg, p_dev, x.to(dev))
    assert torch.equal(out1, out2) and torch.equal(aux1, aux2)
    torch.testing.assert_close(out1.float().cpu(), out_cpu.float(),
                               rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(aux1.cpu(), aux_cpu, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128])
def test_flash_attention_lse_matches_plain_and_leaves_the_output(d):
    """The row log-sum-exp the training backward reads, at every head dim
    (GQA 4:1, also at 40 query heads on 10, lengths that end inside a kv
    tile and a q tile, causal and full): within
    rtol = atol = 1e-4 of the plain version's fp32 logsumexp (the kernel's
    sums are fp32 and its exponentials ex2.approx), and the output with L
    asked for equal bit for bit to the output without it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(100 + d)
    for b, sq, h, kvh, causal in [(2, 200, 8, 2, True), (1, 77, 4, 4, False),
                                  (2, 300, 40, 10, True),
                                  (1, 333, 40, 10, False)]:
        q = torch.randn(b, sq, h, d, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(b, sq, kvh, d, generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        plain = FA.flash_attention(q, k, v, causal=causal)
        out, lse = FA.flash_attention(q, k, v, causal=causal,
                                      return_lse=True)
        _, lse_ref = FA.flash_attention_plain(q, k, v, causal=causal,
                                              return_lse=True)
        assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
        assert torch.equal(out, plain)
        torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("h,kvh,d", [(8, 8, 64), (8, 2, 128), (4, 4, 96),
                                     (40, 10, 128), (40, 10, 96)])
def test_flash_attention_fn_backward_matches_fp32_autograd(h, kvh, d):
    """FlashAttentionFn in bf16 on the card (the kernel's forward with L,
    the written-out backward) against autograd through the plain version in
    fp32 on the same values: o, dq, dk and dv each within 2e-2 of the
    reference's largest magnitude (bf16 rounds o, do and the gradients)."""
    from repro_torch.models.attention import (FlashAttentionFn,
                                              group_query_heads)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(h * d)
    b, s = 2, 160
    q = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, s, kvh, d, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    do = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    o = FlashAttentionFn.apply(group_query_heads(qg, kvh), kg, vg, True, 64,
                               64)
    grads = torch.autograd.grad(o, (qg, kg, vg), group_query_heads(do, kvh))
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    o_ref = FA.flash_attention_plain(qf, kf, vf, causal=True)
    ref = torch.autograd.grad(o_ref, (qf, kf, vf), do.float())
    for name, got, exp in zip(("o", "dq", "dk", "dv"),
                              (o.reshape(b, s, h, d),) + grads,
                              (o_ref,) + ref):
        err = (got.float() - exp).abs().max() / exp.abs().max()
        assert err <= 2e-2, (name, err.item())


#: the backward kernels' shapes (h, kvh, d): stablelm and zamba2's shared
#: block (MHA at 64), granite-moe (GQA 2:1 at 64), yi-6b (GQA 8:1 at 128),
#: phi-3-vision (96) and phi3-medium-14b (GQA 4:1 at 128)
BWD_SHAPES = [(32, 32, 64), (16, 8, 64), (32, 4, 128), (32, 32, 96),
              (40, 10, 128)]


def _bwd_inputs(b, s, h, kvh, d, seed, fused=False):
    """bf16 q, k, v (sliced from one fused projection with ``fused``), the
    forward's o and L, and an upstream gradient do."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if fused:
        qkv = torch.randn(b, s, (h + 2 * kvh) * d, generator=gen,
                          device=dev).bfloat16()
        q = qkv[..., :h * d].unflatten(-1, (h, d))
        k = qkv[..., h * d:(h + kvh) * d].unflatten(-1, (kvh, d))
        v = qkv[..., (h + kvh) * d:].unflatten(-1, (kvh, d))
    else:
        q = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(b, s, kvh, d, generator=gen, device=dev)
                .bfloat16() for _ in range(2))
    do = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
    return q, k, v, do


@pytest.mark.gpu
@pytest.mark.parametrize("s", [160, 512, 520])
@pytest.mark.parametrize("h,kvh,d", BWD_SHAPES)
def test_flash_attention_bwd_kernel_matches_plain_and_fp32(h, kvh, d, s):
    """The backward kernels on the forward's o and L, causal, at every
    training shape and lengths that fill the 64-row tiles, end inside one
    (520) or are shorter than the training sequence (160): dq, dk, dv
    within 1e-2 of the plain version's largest magnitude (the same
    arithmetic; bf16 rounds the outputs at 2^-9, and a P or dS on a
    rounding tie may round the other way in the kernel's exp2 and fp32
    sums), and within 2e-2 of autograd through the plain forward in fp32
    (the tolerance of ``FlashAttentionFn``'s own test: bf16 rounds o, do,
    P, dS and the gradients)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b = 2
    q, k, v, do = _bwd_inputs(b, s, h, kvh, d, seed=h * d + s)
    o, lse = FA.flash_attention(q, k, v, causal=True, return_lse=True)
    got = FB.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    plain = FB.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    ref = torch.autograd.grad(FA.flash_attention_plain(qf, kf, vf),
                              (qf, kf, vf), do.float())
    for name, g, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
        assert g.shape == p.shape and g.dtype == torch.bfloat16, name
        err = ((g.float() - p.float()).abs().max()
               / p.float().abs().max()).item()
        assert err <= 1e-2, (name, "plain", err)
        err = ((g.float() - r).abs().max() / r.abs().max()).item()
        assert err <= 2e-2, (name, "fp32", err)


@pytest.mark.gpu
@pytest.mark.parametrize("d,h,kvh,causal,fused", [
    (16, 4, 4, True, False), (32, 8, 2, False, False),
    (64, 8, 2, False, True), (128, 8, 4, True, True)])
def test_flash_attention_bwd_every_head_dim_full_and_strided(d, h, kvh,
                                                             causal, fused):
    """The head dims only reduced configs use (16, 32: padded to 64),
    full attention, and q, k, v read through the strides of one fused QKV
    projection, at a ragged length: within 1e-2 of the plain version's
    largest magnitude, as above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, s = 2, 200
    q, k, v, do = _bwd_inputs(b, s, h, kvh, d, seed=d, fused=fused)
    o, lse = FA.flash_attention(q, k, v, causal=causal, return_lse=True)
    got = FB.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    plain = FB.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    for name, g, p in zip(("dq", "dk", "dv"), got, plain):
        assert g.shape == p.shape, name
        err = ((g.float() - p.float()).abs().max()
               / p.float().abs().max()).item()
        assert err <= 1e-2, (name, err)


@pytest.mark.gpu
def test_flash_attention_bwd_repeats_its_bits():
    """No atomics and every sum in a fixed order: two calls on the same
    inputs give the same bits (GQA 4:1, so dk and dv sum over a group)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, do = _bwd_inputs(4, 520, 16, 4, 64, seed=7)
    o, lse = FA.flash_attention(q, k, v, causal=True, return_lse=True)
    first = FB.flash_attention_bwd(q, k, v, o, lse, do)
    again = FB.flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_flash_attention_fn_backward_runs_only_the_kernels(monkeypatch):
    """On CUDA tensors ``FlashAttentionFn``'s backward launches the two
    backward kernels once each and never calls ``_flash_bwd``."""
    from repro_torch.models import attention
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def refuse(*args, **kwargs):
        raise AssertionError("_flash_bwd called on CUDA tensors")

    monkeypatch.setattr(attention, "_flash_bwd", refuse)
    q, k, v, do = _bwd_inputs(2, 160, 8, 2, 64, seed=3)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    o = attention.FlashAttentionFn.apply(
        attention.group_query_heads(qg, 2), kg, vg, True, 512, 1024)
    fwd0, bwd0 = FA.launches, FB.launches
    grads = torch.autograd.grad(o, (qg, kg, vg),
                                attention.group_query_heads(do, 2))
    torch.cuda.synchronize()
    assert (FA.launches - fwd0, FB.launches - bwd0) == (0, 2)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.gpu
def test_kernel_wrappers_refuse_grad_on_the_card():
    """ROADMAP C5 on CUDA tensors: flash-attention called on inputs that
    require grad, with grad enabled and outside FlashAttentionFn, raises;
    under no_grad it runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    q = torch.randn(1, 64, 4, 64, device=dev).bfloat16().requires_grad_()
    k = torch.randn(1, 64, 4, 64, device=dev).bfloat16()
    with pytest.raises(RuntimeError, match="no backward"):
        FA.flash_attention(q, k, k)
    with torch.no_grad():
        assert FA.flash_attention(q, k, k).shape == q.shape


@pytest.mark.gpu
def test_trainer_steps_without_a_host_sync_repeat_the_synchronised_bits():
    """The weight update runs on the trainer's stream and the next step's
    chunks on their executor's stream: only an event orders them. Three
    CUDA-only steps of full-width stablelm-1.6b cut to 2 layers, with no
    synchronise between them, give the same loss and weights, bit for bit,
    as the same steps with a synchronise after each."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import DeviceKind
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import OptConfig, tree_leaves, tree_map
    from repro_torch.train.trainer import GroupDef, HeteroTrainer
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg = get_config("stablelm-1.6b").replace(n_layers=2)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)

    def run(sync):
        tr = HeteroTrainer(
            cfg, [GroupDef("accel", DeviceKind.ACCEL, device=dev,
                           fixed_chunk=4, async_depth=2)],
            seq_len=256, global_batch=8,
            oc=OptConfig(lr=1e-3, warmup_steps=1, total_steps=3),
            repeat_data=True, params=tree_map(torch.clone, params))
        losses = []
        for _ in range(3):
            losses.append(tr.train_step().loss)
            if sync:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        return losses, tree_leaves(tr.params)

    loss_sync, w_sync = run(True)
    loss_free, w_free = run(False)
    assert loss_free == loss_sync
    assert all(torch.equal(a, b) for a, b in zip(w_free, w_sync))


@pytest.mark.gpu
def test_ssd_scan_fn_trains_through_the_kernel():
    """``SSDScanFn`` as training runs it, under a checkpoint: K3 launches
    exactly twice a call (forward and recompute), and dx, ddt, dA, dB, dC
    (bf16 for bf16 inputs, fp32 for dt and A) lie within 2e-2 of their
    largest entry from autograd through the plain version in fp32 (the
    bf16 tolerance: bf16 rounds dy, the forward's three intermediates and
    the bf16 gradients). Ragged (200 at chunk 64), and with groups."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.models.ssm import SSDScanFn
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for b, s, nh, g, chunk in [(2, 200, 8, 1, 64), (1, 256, 8, 2, 128)]:
            P = N = 64
            conv = torch.randn(b, s, nh * P + 2 * g * N, generator=gen,
                               device=dev) * 0.5
            dt = F.softplus(torch.randn(b, s, nh, generator=gen, device=dev))
            A = -torch.exp(torch.randn(nh, generator=gen, device=dev) * 0.3)
            dy = torch.randn(b, s, nh, P, generator=gen, device=dev) * 0.1

            def grads(conv, dy, fn):
                leaves = [t.detach().requires_grad_() for t in (conv, dt, A)]
                c = leaves[0]
                x = c[..., :nh * P].unflatten(-1, (nh, P))
                B = c[..., nh * P:nh * P + g * N].unflatten(-1, (g, N))
                C = c[..., nh * P + g * N:].unflatten(-1, (g, N))
                y = fn(x, leaves[1], leaves[2], B, C)
                return torch.autograd.grad(y, leaves, dy)

            SSD.launches = 0
            got = grads(conv.bfloat16(), dy.bfloat16(), lambda *a: checkpoint(
                lambda *a: SSDScanFn.apply(*a, chunk, None)[0], *a,
                use_reentrant=False))
            torch.cuda.synchronize()
            assert SSD.launches == 2
            exp = grads(conv, dy, lambda *a: SSD.ssd_scan_plain(*a, chunk)[0])
            assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                              torch.float32]
            for name, g_, e in zip(("dconv", "ddt", "dA"), got, exp):
                assert bool(torch.isfinite(g_).all()), name
                err = (g_.float() - e).abs().max().item()
                assert err <= 2e-2 * e.abs().max().item(), (name, err)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@pytest.mark.gpu
def test_moe_recompute_routes_as_the_forward_on_the_card():
    """One bf16 grad_step of reduced granite-moe on the card (2 layers, 4
    experts top-2; 4 x 64 tokens, so experts overflow), every router call
    and capacity selection recorded: each layer's recompute in the
    backward picks exactly the forward's experts and keeps exactly its
    tokens, and every gradient is finite."""
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.data.pipeline import for_model
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.train.train_step import grad_step
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg = get_reduced_config("granite-moe-1b-a400m")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in for_model(cfg, 64, 0).batch(0, 4).items()}
    picks, kept = [], []
    route, capacity = MOE._route, MOE._capacity

    def recording_route(cfg_, p, xf):
        out = route(cfg_, p, xf)
        picks.append(out[2])
        return out

    def recording_capacity(cfg_, prio):
        out = capacity(cfg_, prio)
        kept.append(out[1])
        return out

    MOE._route, MOE._capacity = recording_route, recording_capacity
    try:
        grads, _ = grad_step(cfg, params, batch)
    finally:
        MOE._route, MOE._capacity = route, capacity
    n = cfg.n_layers
    assert len(picks) == len(kept) == 2 * n
    for i in range(n):
        assert torch.equal(picks[i], picks[2 * n - 1 - i]), i
        assert torch.equal(kept[i], kept[2 * n - 1 - i]), i
    assert all(bool(torch.isfinite(g).all()) for g in _leaves(grads))



@pytest.mark.gpu
def test_bulk_chunk_of_64_launches_exactly_once_a_layer():
    """chip_smoke.py phase 15a at a 2-layer cut: ``BulkScheduler.run(0, 64,
    1.0)`` over the engine's executor (group ``accel`` alone on cuda:0,
    ``async_depth=2``) on stablelm-1.6b at full width, 64 prompts of 128
    tokens and 16 decode tokens in one bulk chunk: every request served
    once, flash-attention launched once a layer, flash-decode once a layer
    a decode step, and every split ticket back at zero."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import BulkScheduler, DeviceKind, GroupSpec
    from repro_torch.serve.engine import GroupDef, HeteroServeEngine
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg = get_config("stablelm-1.6b").replace(n_layers=2)
    g = GroupDef("accel", DeviceKind.ACCEL, device=dev, async_depth=2)
    eng = HeteroServeEngine(cfg, [g], prompt_len=128, decode_tokens=16)
    bulk = BulkScheduler({"accel": GroupSpec("accel", DeviceKind.ACCEL)},
                         {"accel": eng._executor_for(g)})
    fa0, fd0 = FA.launches, FD.launches
    res = bulk.run(0, 64, 1.0)
    torch.cuda.synchronize()
    assert res.per_group_items == {"accel": 64}
    (rec,) = res.records
    assert (rec.token.chunk.begin, rec.token.chunk.end) == (0, 64)
    toks = rec.meta["result"]["tokens_out"]
    assert toks.shape == (64, 16)
    assert toks.min() >= 0 and toks.max() < cfg.vocab
    assert FA.launches - fa0 == cfg.n_layers
    assert FD.launches - fd0 == cfg.n_layers * 15
    assert not any(int(t.abs().sum()) for t in FD._counters.values())


@pytest.mark.gpu
def test_device_phases_cover_a_graphed_serve_and_a_graphed_step():
    """Through the graphs on cuda:0 in bf16: a warm served call of reduced
    stablelm-1.6b and a warm training step of stablelm-1.6b at full width
    cut to 2 layers, each a call whose device work, not the host's, takes
    the wall time. (A reduced model's training step is the host's: ~12 ms
    of device work beside ~2.5 ms of the host's own, since the attention
    backward runs on its two kernels and no longer on hundreds of small
    ones.) Each phase's device seconds are positive (the host's waits, no
    work of their own, at least 0), and the phases' device seconds sum to
    at least 90% of the call's synchronised wall time and to no more than
    it."""
    import time
    from repro_torch import telemetry
    from repro_torch.configs.registry import get_config, get_reduced_config
    from repro_torch.core import DeviceKind
    from repro_torch.serve.engine import GroupDef, HeteroServeEngine
    from repro_torch.train.trainer import GroupDef as TrainGroup
    from repro_torch.train.trainer import HeteroTrainer
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg = get_reduced_config("stablelm-1.6b").replace(dtype="bfloat16")

    def timed(call):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        rep = call()
        torch.cuda.synchronize(dev)
        return rep, time.perf_counter() - t0

    def check(phases, wall):
        assert phases
        for name, t in phases.items():
            if name.endswith("_wait"):
                assert t["device_s"] >= 0.0, name
            else:
                assert t["device_s"] > 0.0, name
        total = sum(t["device_s"] for t in phases.values())
        assert 0.9 * wall <= total <= wall, (total, wall)

    eng = HeteroServeEngine(
        cfg, [GroupDef("accel", DeviceKind.ACCEL, device=dev,
                       fixed_chunk=16, async_depth=2)],
        prompt_len=64, decode_tokens=64, telemetry=telemetry.Telemetry())
    eng.serve(128)                          # captures the graphs
    rep, wall = timed(lambda: eng.serve(128))
    assert rep.phases["serve.decode"]["steps"] == 8 * 63
    check(rep.phases, wall)

    tr = HeteroTrainer(
        get_config("stablelm-1.6b").replace(n_layers=2),
        [TrainGroup("accel", DeviceKind.ACCEL, device=dev, fixed_chunk=8,
                    async_depth=2)],
        seq_len=128, global_batch=32, telemetry=telemetry.Telemetry())
    tr.train_step()                         # captures the graph

    def step():
        rep = tr.train_step()
        tr.resolve_phases()
        return rep
    rep, wall = timed(step)
    assert rep.phases["train.grad"]["count"] == 4
    assert rep.phases["train.update"]["count"] == 1
    assert tr.graph_counts.snapshot()["replays"] >= 4
    check(rep.phases, wall)


@pytest.mark.gpu
def test_a_step_after_an_unsynchronised_one_leaves_its_update_out_of_grad():
    """Two training steps with no synchronise between them: the second's
    first chunk waits on its stream for the first's update, which is
    still queued (here lengthened by a 50 ms sleep kernel after it). The
    wait is ``train.update_wait``; ``train.grad`` holds the chunks' own
    work alone, as in a step that waits for nothing."""
    from repro_torch import telemetry
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.core import DeviceKind
    from repro_torch.train.trainer import GroupDef, HeteroTrainer
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg = get_reduced_config("stablelm-1.6b").replace(dtype="bfloat16")
    tr = HeteroTrainer(
        cfg, [GroupDef("accel", DeviceKind.ACCEL, device=dev,
                       fixed_chunk=8, async_depth=2)],
        seq_len=128, global_batch=32, telemetry=telemetry.Telemetry())
    tr.train(2)                             # captures the graph
    torch.cuda.synchronize(dev)
    calm = tr.train_step()
    tr.resolve_phases()
    torch.cuda.synchronize(dev)

    # 50 ms on the trainer's stream after the update, before the mark
    # the next step's chunks wait for
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    first = tr.train_step()
    start.record()
    torch.cuda._sleep(int(50e-3 * 1.5e9))
    end.record()
    tr._mark_written()
    second = tr.train_step()
    tr.resolve_phases()
    torch.cuda.synchronize(dev)
    slept = start.elapsed_time(end) * 1e-3
    assert slept > 20e-3
    assert first.phases["train.update"]["count"] == 1
    wait = second.phases["train.update_wait"]
    assert wait["count"] == 4
    assert wait["device_s"] >= 0.5 * slept
    grad, calm_grad = (r.phases["train.grad"]["device_s"]
                       for r in (second, calm))
    assert grad < calm_grad + 0.25 * slept, (grad, calm_grad, slept)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
