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
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import ssd_scan as SSD


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

    for b, sq, h, kvh, d, off in [(2, 100, 4, 2, 16, 0), (2, 64, 8, 8, 64, 0),
                                  (1, 33, 4, 1, 128, 7)]:
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
    q_offset (a prefill continuing a cache), and full attention."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(d)
    for b, sq, h, kvh, off, causal in [(2, 200, 8, 2, 0, True),
                                       (1, 77, 8, 2, 45, True),
                                       (3, 130, 4, 1, 0, False),
                                       (1, 1, 4, 4, 63, True)]:
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
