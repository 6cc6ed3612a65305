#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each uncaught (any failure exits non-zero and prints no result):

1. the card (name and power limit from nvidia-smi), torch and CUDA
   versions, and the build of every CUDA kernel from ``csrc/`` (one nvcc per
   source, all started together), with ptxas's registers, shared memory
   and spills per kernel, and the resident blocks per SM of every
   instantiation (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
2. each kernel against its plain PyTorch version on the card, in bf16 at
   the serving paths' shapes (K1 at each model's prefill: main, ragged,
   gqa, d96, gqa8_d128; K2 at each model's decode: main, ragged, gqa, d96,
   gqa8_d128, b1; K3 at zamba2's): max abs error and tolerance, two times per
   call (``ms``: the device alone, many calls captured in one CUDA graph
   and replayed between CUDA events; ``back_to_back_ms``: the same calls
   issued from Python, so the wrapper's host cost is in it), the bound
   (the larger of bytes over 3.35 TB/s and FLOPs over 989 TFLOP/s), the
   plain version's time and, as a yardstick the port never calls,
   ``F.scaled_dot_product_attention``'s two times (no PyTorch call
   computes the SSD scan); then every other instantiation (K1 at head
   dims 16, 32, 96 and 128, K2 at every (head dim, group) pair with its
   own split count and 3 splits, K3 at (P, N) = (16, 8)) against its
   plain version on small ragged inputs;
3. the model at full width on a small input: stablelm-1.6b cut to 2 layers,
   prefill + 4 greedy decode steps through the kernels, against the same
   run with the kernels' plain versions in their place (bf16, on the card);
4. the main path: ``HeteroServeEngine.serve`` on full-width stablelm-1.6b
   (24 layers, random weights from a torch.Generator seeded with 0), one
   group ``accel:chunk=8:async=2`` on cuda:0, 64 requests of 512 prompt
   tokens and 16 decode tokens; the kernels' launch counts are zeroed just
   before and read just after, and must equal 24 per prefill and 24 per
   decode step;
5. the heterogeneous path: groups ``accel:chunk=8:async=2`` on cuda:0 and
   ``cpu0`` on the CPU, on reduced stablelm-1.6b;
6. the hybrid model at full width on a small input: zamba2-1.2b cut to 7
   layers (its first group of 6 Mamba-2 blocks with the shared attention
   block, then its first tail block), a 300-token prompt and 4 greedy
   decode steps through the kernels in bf16, held against an fp32 run of
   the kernels' plain versions on the same tokens, no farther from it than
   1.5 times the plain versions' own bf16 run;
7. the hybrid main path: ``HeteroServeEngine.serve`` on full-width
   zamba2-1.2b (38 layers, random weights from a torch.Generator seeded
   with 0), the same group and requests as phase 4; launches must equal,
   per chunk, 38 of the SSD scan, 6 of flash-attention and 6 x 15 of
   flash-decode;
8. for phi-3-vision-4.2b (32 layers, head dim 96, a 144-row stubbed
   patch-embedding prefix) and then yi-6b (32 layers, 32 query heads on
   4 kv heads of 128), each at full width with random weights from a
   torch.Generator seeded with 0: phase 3's reference check, then phase
   4's main path, with 32 flash-attention launches per prefill and 32
   flash-decode launches per decode step;
9. the queued path, run after phase 5 on phase 4's weights:
   ``HeteroServeEngine.serve_jobs`` on full-width stablelm-1.6b, 64 jobs
   of one request (512 prompt + 16 decode tokens), tiers urgent /
   standard / batch in turn, tenants ``gold:weight=10,free:weight=1:
   quota=8``, batches of 8 jobs with 2 in flight, an SLO that admits
   every job, and per-tenant energy modelled at the card's power limit;
   every job done, and launches exact for the chunks the run counted;
10. the federated path, run after phase 8 on yi-6b's weights:
   ``serve_jobs_federated`` with 3 runtimes on cuda:0 sharing one weight
   copy, the same jobs at standard priority: with no faults (launches
   exact over the three dispatcher threads, generated tokens held
   against a serial re-run on the default stream), with runtime r1
   killed at half the jobs (one failover, every job done, every split
   ticket back at zero), and under the chaos plan of seed 0.

Then a JSON line with every kernel's numbers, the nvidia-smi line, and as
the last line ``{"ok": true, "device": {...}}``. It needs one card, runs
nothing on the CPU in its place, and fails without ``src/repro_torch``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak
TOL = 2e-2                         # tests/test_kernels.py's bf16 tolerance
TOL_TEXT = f"tol |diff| <= {TOL} + {TOL} |plain|"   # as torch.allclose
#: the SSD scan's tolerance, relative to max |y| and max |state|: kernel
#: and plain version round the same three intermediates to bf16
#: (repro/models/ssm.py:111-134) but sum in other orders, so a weight can
#: round to the neighbouring bf16 value
SSD_TOL = 2e-2


def log(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean time of one call from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, replays: int = 3) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph
    and replayed ``replays`` times between CUDA events, so no host work
    sits between the kernels; warmed up first on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def times(fn, iters: int):
    """(device-only ms, back-to-back ms) of one call."""
    return graph_ms(fn, iters), cuda_ms(fn, iters)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_card():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(_build.KERNELS)}, in parallel)")
    for name, text in _build.build_log.items():
        entry = "?"
        for line in text.splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                entry = _kernel_name(found.group(1))
            elif "registers" in line or "spill" in line:
                log(f"  {name} {entry}: {line.strip()}")
    return smi


def _kernel_name(mangled: str) -> str:
    """``flash_attention_kernel<64>`` from the mangled name ptxas prints."""
    found = re.search(r"([a-z_]+_kernel)(?:I((?:Li\d+E)+)E)?", mangled)
    if not found:
        return mangled
    args = re.findall(r"Li(\d+)E", found.group(2) or "")
    return found.group(1) + (f"<{','.join(args)}>" if args else "")


def phase_occupancy(dev):
    """Resident blocks per SM of every instantiation of the kernels."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels._checks import HEAD_DIMS
    occ = {}
    for d in HEAD_DIMS:
        blocks, smem = FA.occupancy(d, dev)
        occ[f"flash_attention D={d}"] = blocks
        log(f"flash_attention occupancy D={d}: {blocks} resident blocks per "
            f"SM, {smem} bytes of dynamic shared memory per block")
    for d in HEAD_DIMS:
        for group in FD.GROUPS:
            blocks, smem = FD.occupancy(d, group, dev)
            occ[f"flash_decode D={d} group={group}"] = blocks
            log(f"flash_decode occupancy D={d} group={group}: {blocks} "
                f"resident blocks per SM, {smem} bytes of dynamic shared "
                f"memory per block")
    for P, N in SSD.SHAPES:
        blocks, smem = SSD.occupancy(P, N, dev)
        occ[f"ssd_scan P={P} N={N}"] = blocks
        log(f"ssd_scan occupancy P={P} N={N}: {blocks} resident blocks per "
            f"SM, {smem} bytes of dynamic shared memory per block")
    if min(occ.values()) < 1:
        raise AssertionError(f"an instantiation cannot launch: {occ}")
    return occ


def phase_kernels(dev):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD

    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev) \
            .to(torch.bfloat16)

    rows = {"flash_attention": {"shapes": {}}, "flash_decode": {"shapes": {}}}
    # K1 at the prefill shapes of the four served models (b=8), causal
    fa_err = 0.0
    for name, sq, h, kvh, d in [("main", 512, 32, 32, 64),
                                ("ragged", 1000, 32, 32, 64),
                                ("gqa", 512, 32, 8, 64),
                                ("d96", 656, 32, 32, 96),
                                ("gqa8_d128", 512, 32, 4, 128)]:
        b = 8
        q, k, v = rnd(b, sq, h, d), rnd(b, sq, kvh, d), rnd(b, sq, kvh, d)
        out = FA.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        exp = FA.flash_attention_plain(q, k, v, causal=True)
        err = (out.float() - exp.float()).abs().max().item()
        if not torch.allclose(out.float(), exp.float(), rtol=TOL, atol=TOL):
            raise AssertionError(f"flash_attention {name}: max abs err {err}")
        fa_err = max(fa_err, err)
        ms, b2b_ms = times(
            lambda: FA.flash_attention(q, k, v, causal=True), 50)
        plain_ms = cuda_ms(
            lambda: FA.flash_attention_plain(q, k, v, causal=True), 5)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_ms, lib_b2b_ms = times(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=h != kvh), 50)
        nbytes = 2 * (2 * b * sq * h * d + 2 * b * sq * kvh * d)
        flops = 4 * b * h * d * (sq * (sq + 1) // 2)
        b_ms, b_by = bound(nbytes, flops)
        log(f"flash_attention {name}: b={b} S={sq} H={h} KVH={kvh} D={d} "
            f"max_abs_err={err:.3e} ({TOL_TEXT}) ms={ms:.4f} (back to back "
            f"{b2b_ms:.4f}) plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
            f"(back to back {lib_b2b_ms:.4f}) bound_ms={b_ms:.4f} ({b_by})")
        row = dict(ms=ms, back_to_back_ms=b2b_ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   library_back_to_back_ms=lib_b2b_ms, max_abs_err=err)
        rows["flash_attention"]["shapes"][name] = row
        if name == "main":
            rows["flash_attention"].update(row)
    rows["flash_attention"]["max_abs_err"] = fa_err

    # K2 against a 1024-row cache at the decode shapes of the served models
    fd_err = 0.0
    for name, b, h, kvh, d, lens in [("main", 8, 32, 32, 64, 520),
                                     ("ragged", 8, 32, 32, 64, None),
                                     ("gqa", 8, 32, 8, 64, None),
                                     ("d96", 8, 32, 32, 96, 664),
                                     ("gqa8_d128", 8, 32, 4, 128, 520),
                                     ("b1", 1, 32, 32, 64, 520)]:
        S = 1024
        q, kc, vc = rnd(b, 1, h, d), rnd(b, S, kvh, d), rnd(b, S, kvh, d)
        if lens is not None:
            kv_len = torch.full((b,), lens, dtype=torch.int32, device=dev)
        else:
            kv_len = torch.randint(1, S + 1, (b,), generator=gen,
                                   device=dev, dtype=torch.int32)
        out = FD.flash_decode(q, kc, vc, kv_len)
        torch.cuda.synchronize()
        exp = FD.flash_decode_plain(q, kc, vc, kv_len)
        err = (out.float() - exp.float()).abs().max().item()
        if not torch.allclose(out.float(), exp.float(), rtol=TOL, atol=TOL):
            raise AssertionError(f"flash_decode {name}: max abs err {err}")
        fd_err = max(fd_err, err)
        ms, b2b_ms = times(lambda: FD.flash_decode(q, kc, vc, kv_len), 200)
        plain_ms = cuda_ms(lambda: FD.flash_decode_plain(q, kc, vc, kv_len),
                           10)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kc, vc))
        mask = (torch.arange(S, device=dev)[None, :]
                < kv_len[:, None])[:, None, None, :]
        lib_ms, lib_b2b_ms = times(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=h != kvh), 200)
        rows_read = int(kv_len.sum().item())
        nbytes = 2 * (2 * b * h * d + 2 * rows_read * kvh * d) + 4 * b
        flops = 4 * rows_read * h * d
        b_ms, b_by = bound(nbytes, flops)
        n_split = FD.split_count(
            b, kvh, S, torch.cuda.get_device_properties(dev)
            .multi_processor_count)
        # the device time at other split counts, for the split policy
        sweep = {n: graph_ms(lambda: FD.flash_decode(q, kc, vc, kv_len,
                                                     n_split=n), 200)
                 for n in (1, 2, 4, 8, 16)}
        log(f"flash_decode {name}: b={b} S={S} H={h} KVH={kvh} D={d} "
            f"kv_len sum={rows_read} n_split={n_split} max_abs_err="
            f"{err:.3e} ({TOL_TEXT}) ms={ms:.4f} (back to back {b2b_ms:.4f})"
            f" plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} (back to back "
            f"{lib_b2b_ms:.4f}) bound_ms={b_ms:.4f} ({b_by}); ms by "
            f"n_split: " + ", ".join(f"{n}: {t:.4f}"
                                     for n, t in sweep.items()))
        row = dict(ms=ms, back_to_back_ms=b2b_ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   library_back_to_back_ms=lib_b2b_ms, max_abs_err=err,
                   n_split=n_split, ms_by_n_split=sweep)
        rows["flash_decode"]["shapes"][name] = row
        if name == "main":
            rows["flash_decode"].update(row)
    rows["flash_decode"]["max_abs_err"] = fd_err
    rows["ssd_scan"] = ssd_rows(dev, gen)
    kernel_variants(dev, gen)
    return rows


def kernel_variants(dev, gen):
    """The instantiations the main shapes do not reach, against their
    plain versions: K1 at head dims 16, 32, 96 and 128 (GQA 4:1, ragged, a
    q_offset), K2 at every (head dim, group) pair (ragged lengths, its own
    split count and 3 splits), K3 at (P, N) = (16, 8) (ragged at chunk
    16, 2 groups, a seeded state)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels._checks import HEAD_DIMS
    fd_err = 0.0
    for d in HEAD_DIMS:
        for group in FD.GROUPS:
            b, S, kvh = 2, 300, 2
            q = torch.randn(b, 1, kvh * group, d, generator=gen,
                            device=dev).bfloat16()
            kc, vc = (torch.randn(b, S, kvh, d, generator=gen,
                                  device=dev).bfloat16() for _ in range(2))
            kv_len = torch.randint(1, S + 1, (b,), generator=gen,
                                   device=dev, dtype=torch.int32)
            exp = FD.flash_decode_plain(q, kc, vc, kv_len).float()
            for n_split in (None, 3):
                out = FD.flash_decode(q, kc, vc, kv_len, n_split=n_split)
                torch.cuda.synchronize()
                fd_err = max(fd_err, (out.float() - exp).abs().max().item())
                if not torch.allclose(out.float(), exp, rtol=TOL, atol=TOL):
                    raise AssertionError(
                        f"flash_decode D={d} group={group} n_split="
                        f"{n_split}: max abs err {fd_err}")
    log(f"flash_decode every (D, group) in {HEAD_DIMS} x {FD.GROUPS}: b=2 "
        f"S=300 KVH=2 ragged, n_split its own and 3: max_abs_err="
        f"{fd_err:.3e} ({TOL_TEXT})")
    for d in (16, 32, 96, 128):
        b, sq, off, h, kvh = 2, 150, 37, 8, 2
        q = torch.randn(b, sq, h, d, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(b, sq + off, kvh, d, generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        out = FA.flash_attention(q, k, v, causal=True, q_offset=off)
        torch.cuda.synchronize()
        exp = FA.flash_attention_plain(q, k, v, causal=True, q_offset=off)
        err = (out.float() - exp.float()).abs().max().item()
        log(f"flash_attention D={d}: b={b} Sq={sq} q_offset={off} H={h} "
            f"KVH={kvh} max_abs_err={err:.3e} ({TOL_TEXT})")
        if not torch.allclose(out.float(), exp.float(), rtol=TOL, atol=TOL):
            raise AssertionError(f"flash_attention D={d}: max abs err {err}")
    b, s, nh, P, g, N, Q = 2, 37, 8, 16, 2, 8, 16
    x = (torch.randn(b, s, nh, P, generator=gen, device=dev) * 0.5).bfloat16()
    B, C = ((torch.randn(b, s, g, N, generator=gen, device=dev) * 0.5)
            .bfloat16() for _ in range(2))
    dt = F.softplus(torch.randn(b, s, nh, generator=gen, device=dev))
    A = -torch.exp(torch.randn(nh, generator=gen, device=dev) * 0.3)
    init = torch.randn(b, nh, P, N, generator=gen, device=dev)
    y, st = SSD.ssd_scan(x, dt, A, B, C, Q, init)
    torch.cuda.synchronize()
    ey, est = SSD.ssd_scan_plain(x, dt, A, B, C, Q, init)
    rel_y = ((y.float() - ey.float()).abs().max()
             / ey.float().abs().max()).item()
    rel_s = ((st - est).abs().max() / est.abs().max()).item()
    log(f"ssd_scan P={P} N={N}: b={b} S={s} nh={nh} g={g} Q={Q} "
        f"init_state=True max err {rel_y:.3e} of max |y|, {rel_s:.3e} of "
        f"max |state| (tol {SSD_TOL} of max)")
    if not (rel_y <= SSD_TOL and rel_s <= SSD_TOL):
        raise AssertionError(f"ssd_scan P={P} N={N}: {rel_y}, {rel_s}")


def ssd_rows(dev, gen):
    """K3 at the zamba2 prefill shape (b=8, 64 heads, P=N=64, chunk 128),
    x/B/C as column slices of one conv output, inputs scaled as
    tests/test_kernels.py::test_ssd_scan_sweep scales them."""
    import torch.nn.functional as F
    from repro_torch.kernels import ssd_scan as SSD
    row, max_err = None, 0.0
    for name, s, g, with_init in [("main", 512, 1, False),
                                  ("ragged", 1000, 1, True),
                                  ("grouped", 512, 8, False)]:
        b, nh, P, N, Q = 8, 64, 64, 64, 128
        conv = (torch.randn(b, s, nh * P + 2 * g * N, generator=gen,
                            device=dev) * 0.5).to(torch.bfloat16)
        x = conv[..., :nh * P].unflatten(-1, (nh, P))
        B = conv[..., nh * P:nh * P + g * N].unflatten(-1, (g, N))
        C = conv[..., nh * P + g * N:].unflatten(-1, (g, N))
        dt = F.softplus(torch.randn(b, s, nh, generator=gen, device=dev))
        A = -torch.exp(torch.randn(nh, generator=gen, device=dev) * 0.3)
        init = torch.randn(b, nh, P, N, generator=gen, device=dev) \
            if with_init else None
        args = (x, dt, A, B, C, Q, init)
        y, st = SSD.ssd_scan(*args)
        torch.cuda.synchronize()
        ey, est = SSD.ssd_scan_plain(*args)
        err_y = (y.float() - ey.float()).abs().max().item()
        err_s = (st - est).abs().max().item()
        rel_y = err_y / ey.float().abs().max().item()
        rel_s = err_s / est.abs().max().item()
        if not (rel_y <= SSD_TOL and rel_s <= SSD_TOL):
            raise AssertionError(f"ssd_scan {name}: max err y {err_y} "
                                 f"({rel_y:.3e} of max), state {err_s} "
                                 f"({rel_s:.3e} of max)")
        max_err = max(max_err, err_y)
        ms, b2b_ms = times(lambda: SSD.ssd_scan(*args), 20)
        plain_ms = cuda_ms(lambda: SSD.ssd_scan_plain(*args), 3)
        # each input read once, each output written once; the products
        # the function needs: the causal Q x Q blocks (C.B^T and W.x over
        # the lower triangle), C.S_in and the state update, per chunk
        nbytes = 2 * (2 * b * s * nh * P + 2 * b * s * g * N) \
            + 4 * (b * s * nh + nh) \
            + 4 * b * nh * P * N * (2 if with_init else 1)
        flops = 0
        for c0 in range(0, s, Q):
            L = min(Q, s - c0)
            flops += b * nh * (L * (L + 1) // 2 * 2 * (N + P)
                               + 4 * L * N * P)
        b_ms, b_by = bound(nbytes, flops)
        log(f"ssd_scan {name}: b={b} S={s} nh={nh} P={P} N={N} g={g} "
            f"Q={Q} init_state={with_init} max_abs_err y={err_y:.3e} "
            f"({rel_y:.3e} of max |y|) state={err_s:.3e} ({rel_s:.3e} of "
            f"max |state|) (tol {SSD_TOL} of max) ms={ms:.4f} (back to "
            f"back {b2b_ms:.4f}) plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
            f"({b_by}; "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        if name == "main":
            row = dict(ms=ms, back_to_back_ms=b2b_ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None,
                       library_back_to_back_ms=None)
    row["max_abs_err"] = max_err
    return row


class plain_kernels:
    """Within the block, the model calls the kernels' plain versions
    instead of the kernels (the reference runs of phases 3 and 6)."""

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.kernels.flash_attention import flash_attention_plain
        from repro_torch.kernels.flash_decode import flash_decode_plain
        from repro_torch.kernels.ssd_scan import ssd_scan_plain
        self.ops = ops
        self.saved = (ops.attention_bshd, ops.decode_attention_bshd,
                      ops.ssd_bshn)
        ops.attention_bshd = lambda q, k, v, n_heads, n_kv_heads, causal, \
            q_offset: flash_attention_plain(q, k, v, causal=causal,
                                            q_offset=q_offset)
        ops.decode_attention_bshd = lambda q, kc, vc, kv_len, n_heads, \
            n_kv_heads: flash_decode_plain(q, kc, vc, kv_len)
        ops.ssd_bshn = lambda x, dt, A, B, C, chunk, init_state: \
            ssd_scan_plain(x, dt, A, B, C, chunk, init_state)
        return self

    def __exit__(self, *exc):
        (self.ops.attention_bshd, self.ops.decode_attention_bshd,
         self.ops.ssd_bshn) = self.saved


def _launches():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import ssd_scan as SSD
    return {"flash_attention": FA.launches, "flash_decode": FD.launches,
            "ssd_scan": SSD.launches}


def _zero_launches():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import ssd_scan as SSD
    FA.launches = FD.launches = SSD.launches = 0


def phase_reference(dev, cfg, params):
    """The model at full width on a small input, cut to 2 layers (the
    first 2 of the main path's weights): prefill + 4 greedy decode steps
    through the kernels, against the same run with the kernels' plain
    versions in their place, both in bf16 on the card. The two differ by
    bf16 rounding inside attention, which the random weights' very sharp
    softmax amplifies from layer to layer: tolerance max |dlogit| <=
    5e-2 * max |logit|. A model with a modality prefix (phi-3-vision)
    gets random prefix embeddings, as the engine feeds it."""
    from repro_torch.models import model as M
    cfg2 = cfg.replace(n_layers=2)
    params2 = dict(params, blocks=_map(lambda t: t[:2], params["blocks"]))
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                           dtype=torch.int32).to(dev)
    prefix = None
    if cfg.prefix_len:
        prefix = (torch.randn(2, cfg.prefix_len, cfg.d_model, generator=gen)
                  * 0.02).to(dev)
    max_len = 128 + cfg.prefix_len

    def run():
        out = []
        with torch.no_grad():
            logits, cache = M.prefill(cfg2, params2, tokens, prefix,
                                      max_len=max_len)
            out.append(logits.float())
            for _ in range(4):
                tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                logits, cache = M.decode_step(cfg2, params2, cache, tok)
                out.append(logits.float())
        return torch.stack(out)

    _zero_launches()
    got = run()
    counts = _launches()
    if counts != {"flash_attention": 2, "flash_decode": 8, "ssd_scan": 0}:
        raise AssertionError(f"the reference check's launches: {counts}")
    with plain_kernels():
        ref = run()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite logits through the kernels")
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    same = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"reference check ({cfg.arch_id} widths, 2 layers, b=2, prompt 64"
        f"{f' + {cfg.prefix_len} prefix rows' if prefix is not None else ''}"
        f", 4 decode steps, bf16): kernels vs plain versions, max |dlogit| / "
        f"max |logit| = {rel:.3e} (tol 5e-2), greedy tokens equal "
        f"{same:.3f}")
    if rel > 5e-2:
        raise AssertionError(f"full-width logits off: max rel err {rel}")


def _serve(cfg, groups, requests, prompt_len, decode_tokens, params=None):
    from repro_torch.serve.engine import HeteroServeEngine
    eng = HeteroServeEngine(cfg, groups, prompt_len=prompt_len,
                            decode_tokens=decode_tokens, seed=0,
                            params=params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    rep = eng.serve(requests)
    counts = _launches()
    torch.cuda.synchronize()
    if rep.requests != requests or sum(rep.per_group_items.values()) \
            != requests or sorted(rep.tokens_out) != list(range(requests)):
        raise AssertionError(f"not every request was served: {rep}")
    for i, toks in rep.tokens_out.items():
        if toks.shape != (decode_tokens,) or toks.min() < 0 \
                or toks.max() >= cfg.vocab:
            raise AssertionError(f"request {i}: bad tokens {toks}")
    return eng, rep, counts


def _report(rep, group):
    return {
        "requests": rep.requests,
        "new_tokens": rep.new_tokens,
        "time_s": rep.time_s,
        "tok_per_s": rep.new_tokens / max(rep.time_s, 1e-9),
        "per_group": rep.per_group_items,
        "accel_overheads": rep.overheads.get(group, {}),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }


def full_width_model(dev, arch):
    """``arch`` at full width (bf16), random weights from a
    torch.Generator seeded with 0."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{arch}: {n_params} parameters in {cfg.dtype}, init "
        f"{time.perf_counter() - t0:.2f} s")
    return cfg, params


def phase_main(dev, cfg, params, per_prefill, per_decode_step):
    """The main path on ``cfg``: launches must equal, per chunk,
    ``per_prefill[k]`` + ``per_decode_step[k]`` x 15 for each kernel k."""
    from repro_torch.core.types import DeviceKind
    from repro_torch.serve.engine import GroupDef
    requests, prompt_len, decode_tokens = 64, 512, 16
    groups = [GroupDef("accel", DeviceKind.ACCEL, device=dev, fixed_chunk=8,
                       async_depth=2)]
    eng, rep, counts = _serve(cfg, groups, requests, prompt_len,
                              decode_tokens, params=params)
    chunks = rep.overheads["accel"]["n_chunks"]
    want = {k: chunks * (per_prefill.get(k, 0) + (decode_tokens - 1)
                         * per_decode_step.get(k, 0)) for k in counts}
    out = _report(rep, "accel")
    out.update(max_len=eng.max_len, chunks=chunks, launches=counts)
    log(f"main path report ({cfg.arch_id}): " + json.dumps(out))
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    return counts, out


def phase_hetero(dev, main_out):
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import DeviceKind
    from repro_torch.serve.engine import GroupDef
    cfg = reduced(get_config("stablelm-1.6b"))
    groups = [GroupDef("accel", DeviceKind.ACCEL, device=dev, fixed_chunk=8,
                       async_depth=2),
              GroupDef("cpu0", DeviceKind.BIG, device=torch.device("cpu"))]
    _, rep, counts = _serve(cfg, groups, 64, 128, 16)
    out = _report(rep, "accel")
    out["launches"] = counts
    log("heterogeneous report (reduced stablelm-1.6b): " + json.dumps(out))
    log("accel overheads, main path vs heterogeneous: "
        + json.dumps({"main": main_out["accel_overheads"],
                      "hetero": out["accel_overheads"]}))
    if min(rep.per_group_items.get(g.name, 0) for g in groups) < 1:
        raise AssertionError(f"requests not split: {rep.per_group_items}")
    if counts["flash_attention"] < 1 or counts["flash_decode"] < 1:
        raise AssertionError(f"accel group ran no kernel: {counts}")


def hybrid_cut(cfg, params, n_layers):
    """zamba2 cut to its first ``n_layers`` Mamba-2 blocks (the main
    path's weights): from 6 on, the first group with the shared block,
    then ``n_layers - 6`` tail blocks; below 6, tail blocks only."""
    if n_layers >= cfg.hybrid.attn_every:
        k = cfg.hybrid.attn_every
        return cfg.replace(n_layers=n_layers), dict(
            params, groups=_map(lambda t: t[:1], params["groups"]),
            tail=_map(lambda t: t[:n_layers - k], params["tail"]))
    cut = {k: v for k, v in params.items() if k != "groups"}
    cut["tail"] = _map(lambda t: t[0, :n_layers], params["groups"])
    return cfg.replace(n_layers=n_layers, hybrid=dataclasses.replace(
        cfg.hybrid, attn_every=n_layers + 1)), cut


def hybrid_runs(dev, cfg, params, n_layers):
    """A 300-token prompt (b=2; two whole SSD chunks and a ragged third)
    and 4 greedy decode steps on ``hybrid_cut(n_layers)``, three ways: bf16
    through the kernels, bf16 through the kernels' plain versions, and
    fp32 (weights cast up) through the plain versions with TF32 off. The
    second and third runs are fed the first run's greedy tokens, so every
    step compares like with like. Returns the three stacked logits, the
    kernel run's launch counts and each run's greedy tokens."""
    from repro_torch.models import model as M
    cfg_n, params_n = hybrid_cut(cfg, params, n_layers)
    gen = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, (2, 300), generator=gen,
                           dtype=torch.int32).to(dev)

    def run(c, p, forced=None):
        out, toks = [], []
        with torch.no_grad():
            logits, cache = M.prefill(c, p, prompt, max_len=512)
            for step in range(5):
                out.append(logits.float())
                toks.append(logits[:, -1].argmax(-1).to(torch.int32))
                if step < 4:
                    feed = toks[-1] if forced is None else forced[step]
                    logits, cache = M.decode_step(c, p, cache, feed[:, None])
        return torch.stack(out), torch.stack(toks)

    _zero_launches()
    got, toks = run(cfg_n, params_n)
    counts = _launches()
    tf32 = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with plain_kernels():
            plain, plain_toks = run(cfg_n, params_n, toks)
            ref, ref_toks = run(cfg_n.replace(dtype="float32"),
                                _map(lambda t: t.float(), params_n), toks)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    return (got, plain, ref), counts, (toks, plain_toks, ref_toks)


def rel_err(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def phase_reference_hybrid(dev, cfg, params):
    """zamba2-1.2b at full width cut to 7 layers (the main path's first
    group of 6 Mamba-2 blocks with the shared attention block, then its
    first tail block), through ``hybrid_runs``. On these random weights
    the bf16 model drifts from its fp32 self by ~1.4% of max |logit| per
    layer whichever way the scan rounds (scripts/hybrid_drift.py), so the
    kernels are held against that drift: max |dlogit| / max |logit| of
    the kernel run from the fp32 run must be at most 1.5 times the plain
    bf16 run's. Reported beside it: kernels vs plain versions, and the
    share of greedy tokens that agree with the fp32 run's."""
    (got, plain, ref), counts, (toks, plain_toks, ref_toks) = hybrid_runs(
        dev, cfg, params, 7)
    want = {"flash_attention": 1, "flash_decode": 4, "ssd_scan": 7}
    if counts != want:
        raise AssertionError(f"hybrid reference check launches {counts}, "
                             f"expected {want}")
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite hybrid logits through the kernels")
    err_k, err_p = rel_err(got, ref), rel_err(plain, ref)
    same_k = (toks == ref_toks).float().mean().item()
    same_p = (plain_toks == ref_toks).float().mean().item()
    log(f"reference check (zamba2-1.2b widths, 7 layers, b=2, prompt 300, "
        f"4 decode steps): launches {json.dumps(counts)}; max |dlogit| / "
        f"max |logit| from the fp32 run: kernels (bf16) {err_k:.3e}, plain "
        f"versions (bf16) {err_p:.3e} (tol: kernels <= 1.5 x plain = "
        f"{1.5 * err_p:.3e}); kernels vs plain {rel_err(got, plain):.3e}; "
        f"greedy tokens equal to the fp32 run's: kernels {same_k:.3f}, "
        f"plain {same_p:.3f}")
    if not err_k <= 1.5 * err_p:
        raise AssertionError(f"full-width hybrid logits off: {err_k} from "
                             f"fp32 against the plain bf16 run's {err_p}")


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def free_model():
    """Drop the previous model's weights before the next one is drawn:
    the engines' executors hold closures over their engine, a reference
    cycle, so collect it, or the weights stay allocated and count in the
    next model's peak memory."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"device memory allocated before the next model: "
        f"{torch.cuda.memory_allocated()} bytes")


TENANTS = "gold:weight=10,free:weight=1:quota=8"
#: a queue-delay SLO no job of these runs comes near: admission admits all
SLO_ADMIT_ALL_S = 3600.0
JOBS, JOB_PROMPT, JOB_DECODE = 64, 512, 16
MODELLED = "modelled: busy seconds x power limit, not measured"


def _power_limit_w(smi: str) -> float:
    """The watts of nvidia-smi's ``name, 700.00 W`` line."""
    return float(smi.rsplit(",", 1)[1].split()[0])


def _jobs(registry, priority):
    """``JOBS`` jobs of one request each, spread round-robin over the
    tenants, in the launcher's tiers (``mix`` cycles urgent / standard /
    batch)."""
    from repro_torch.core.types import TIERS
    from repro_torch.queue import Job
    names = registry.names()
    return [Job(items=1, priority=i % 3,
                tier=TIERS[i % len(TIERS)] if priority == "mix"
                else priority, tenant=names[i % len(names)])
            for i in range(JOBS)]


def _recording_engine(cfg, params, dev, telemetry):
    """A ``HeteroServeEngine`` (group ``accel:chunk=8:async=2`` on
    ``dev``, the loaded weights) whose executors keep, for every chunk
    they fetch, its padded prompt batch and its generated tokens: a
    wrapper around each executor's step (to carry the prompt batch along)
    and fetch. The engine itself is unchanged."""
    from repro_torch.core.types import DeviceKind
    from repro_torch.serve.engine import GroupDef, HeteroServeEngine

    class RecordingEngine(HeteroServeEngine):
        def _make_executor(self, g, key=None):
            ex = super()._make_executor(g, key)
            step, fetch = ex.step, ex.fetch

            def step_keeping_prompts(batch):
                return step(batch), batch["tokens"]

            def fetch_keeping_tokens(outs):
                toks, prompts = outs
                res = fetch(toks)
                self.fetched.append((prompts.cpu().numpy(),
                                     res["tokens_out"]))
                return res

            ex.step, ex.fetch = step_keeping_prompts, fetch_keeping_tokens
            return ex

    groups = [GroupDef("accel", DeviceKind.ACCEL, device=dev, fixed_chunk=8,
                       async_depth=2)]
    eng = RecordingEngine(cfg, groups, prompt_len=JOB_PROMPT,
                          decode_tokens=JOB_DECODE, seed=0,
                          telemetry=telemetry, params=params)
    eng.fetched = []
    return eng


def _chunks_counted(telemetry) -> int:
    """Chunks the run's schedulers counted (``sched.chunks``, every group
    and runtime); fails if the registry dropped a completion batch."""
    snap = telemetry.registry.snapshot()
    if snap["gauges"].get("sched.observe_lost_batches"):
        raise AssertionError("telemetry lost completion batches")
    return int(sum(v for k, v in snap["counters"].items()
                   if k.startswith("sched.chunks")))


def _overlapped_batches(telemetry) -> int:
    """Batches submitted before the previous batch finished, from the
    service's ``batch:N`` spans (submitted -> finished, N in finishing
    order): the count ``ServiceStats.record_window`` keeps."""
    spans = sorted((int(e["name"].split(":")[1]), e["ts"], e["ts"] + e["dur"])
                   for e in telemetry.tracer.chrome_events()
                   if e.get("cat") == "service"
                   and e["name"].startswith("batch:"))
    return sum(1 for prev, cur in zip(spans, spans[1:]) if cur[1] < prev[2])


def _expect_launches(counts, chunks, n_layers):
    want = {"flash_attention": chunks * n_layers,
            "flash_decode": chunks * n_layers * (JOB_DECODE - 1),
            "ssd_scan": 0}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want} "
                             f"for {chunks} chunks")


def phase_queued(dev, cfg, params, smi):
    """Phase 9: ``serve_jobs`` on full-width stablelm-1.6b (phase 4's
    weights): 64 jobs of one request (512 prompt + 16 decode tokens),
    tenants gold (weight 10) and free (weight 1, quota 8), tiers urgent /
    standard / batch in turn, batches of 8 jobs, 2 batches in flight, an
    SLO that admits every job, and an energy model billing the accel
    group at the card's power limit (idle 0 W)."""
    from repro_torch import telemetry as telemetry_mod
    from repro_torch.core.energy import EnergyModel, PowerSpec
    from repro_torch.tenancy import TenantRegistry
    registry = TenantRegistry.parse(TENANTS)
    watts = _power_limit_w(smi)
    energy = EnergyModel({"accel": PowerSpec(active_w=watts, idle_w=0.0)})
    tel = telemetry_mod.Telemetry()
    eng = _recording_engine(cfg, params, dev, tel)
    jobs = _jobs(registry, "mix")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    rep = eng.serve_jobs(jobs, slo_delay_s=SLO_ADMIT_ALL_S, batch_jobs=8,
                         pipeline_depth=2, tenants=registry,
                         energy_model=energy, timeout_s=300.0)
    counts = _launches()
    torch.cuda.synchronize()
    chunks = _chunks_counted(tel)
    items = sum(u["items"] for u in rep.per_tenant.values())
    out = {
        "jobs": rep.jobs, "done": rep.done, "failed": rep.failed,
        "cancelled": rep.cancelled, "drained": rep.drained,
        "batches": rep.batches, "chunks": chunks,
        "new_tokens": rep.new_tokens, "time_s": rep.time_s,
        "tok_per_s": rep.new_tokens / max(rep.time_s, 1e-9),
        "queue_delay_s": rep.queue_delay,
        "express_batches": rep.express_batches,
        "overlapped_batches": _overlapped_batches(tel),
        "per_tenant": {t: {k: u[k] for k in ("items", "busy_s", "energy_j",
                                             "edp")}
                       for t, u in rep.per_tenant.items()},
        "energy": f"{MODELLED} ({watts} W)",
        "launches": counts,
        "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log("queued path report (stablelm-1.6b, serve_jobs): " + json.dumps(out))
    if not rep.drained or rep.done != JOBS or rep.failed or rep.cancelled:
        raise AssertionError(f"queued run incomplete: {out}")
    if items != JOBS or len(eng.fetched) != chunks:
        raise AssertionError(f"per-tenant items {items}, fetched chunks "
                             f"{len(eng.fetched)}, counted {chunks}")
    _expect_launches(counts, chunks, cfg.n_layers)
    return counts


def _greedy(cfg, params, prompts, max_len):
    """The engine's step, serially on the default stream: prefill then
    ``JOB_DECODE - 1`` greedy decode steps."""
    from repro_torch.models import model as M
    with torch.no_grad():
        logits, cache = M.prefill(cfg, params, torch.as_tensor(
            prompts, device=params["embed"].device), max_len=max_len)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        toks = [tok]
        for _ in range(JOB_DECODE - 1):
            logits, cache = M.decode_step(cfg, params, cache, tok)
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            toks.append(tok)
        return torch.cat(toks, dim=1).cpu().numpy()


def _fed_out(frep):
    fed = frep.fed
    return {
        "runtimes": fed.runtimes, "alive": fed.alive, "jobs": fed.jobs,
        "done": fed.done, "failed": fed.failed, "cancelled": fed.cancelled,
        "requeues": fed.requeues, "recovered": fed.recovered,
        "failovers": fed.failovers, "killed": fed.killed,
        "drained": frep.drained, "new_tokens": frep.new_tokens,
        "time_s": fed.time_s,
        "tok_per_s": frep.new_tokens / max(fed.time_s, 1e-9),
        "per_runtime": fed.per_runtime,
        "per_tenant_items": fed.per_tenant_items,
        "max_memory_allocated": torch.cuda.max_memory_allocated()}


def phase_federated(dev, cfg, params):
    """Phase 10: ``serve_jobs_federated`` on full-width yi-6b (phase 8's
    weights), 3 runtimes on cuda:0 sharing one copy of the weights, the
    same 64 jobs at standard priority and the same tenants, three runs:
    no faults (exact launch counts over the three dispatcher threads, and
    the generated tokens held against a serial re-run of the same padded
    prompt batches on the default stream), runtime r1 killed once half
    the jobs are done, and the chaos plan of seed 0 over 2 s."""
    from repro_torch import telemetry as telemetry_mod
    from repro_torch.chaos import FaultPlan
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.tenancy import TenantRegistry
    registry = TenantRegistry.parse(TENANTS)
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    tel = telemetry_mod.Telemetry()
    eng = _recording_engine(cfg, params, dev, tel)
    added = torch.cuda.memory_allocated() - base
    log(f"federated engine built: {added} bytes of device memory added "
        f"(one weight copy is {weight_bytes} bytes)")
    if added >= weight_bytes:
        raise AssertionError("the federated engine copied the weights")
    kw = dict(runtimes=3, slo_delay_s=SLO_ADMIT_ALL_S, batch_jobs=8,
              pipeline_depth=2, tenants=registry, timeout_s=300.0)

    # run 1: no faults
    jobs = _jobs(registry, "standard")
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    frep = eng.serve_jobs_federated(jobs, **kw)
    counts = _launches()
    torch.cuda.synchronize()
    chunks = _chunks_counted(tel)
    out = _fed_out(frep)
    peak_added = out["max_memory_allocated"] - base
    out.update(chunks=chunks, launches=counts, peak_added=peak_added)
    log("federated report, no faults (yi-6b, 3 runtimes): "
        + json.dumps(out))
    if not frep.drained or out["jobs"] != JOBS or out["done"] != JOBS \
            or any(j.state.value != "done" for j in jobs):
        raise AssertionError(f"federated run incomplete: {out}")
    if len(eng.fetched) != chunks:
        raise AssertionError(f"fetched {len(eng.fetched)} chunks, counted "
                             f"{chunks}")
    _expect_launches(counts, chunks, cfg.n_layers)
    if peak_added >= weight_bytes:
        raise AssertionError(f"three runtimes added {peak_added} bytes at "
                             f"peak: more than one weight copy")
    serial, equal, total = {}, 0, 0
    for prompts, toks in eng.fetched:
        key = prompts.tobytes()
        if key not in serial:
            serial[key] = _greedy(cfg, params, prompts, eng.max_len)
        equal += int((serial[key] == toks).sum())
        total += toks.size
    agree = equal / total
    log(f"federated tokens against a serial re-run of the same "
        f"{len(serial)} distinct padded prompt batches on the default "
        f"stream: {equal} of {total} equal ({agree:.4f}; need >= 0.9)")
    if agree < 0.9:
        raise AssertionError(f"federated tokens agree {agree}")

    # run 2: the kill drill
    jobs = _jobs(registry, "standard")
    torch.cuda.reset_peak_memory_stats()
    frep = eng.serve_jobs_federated(jobs, kill_runtime=1,
                                    kill_after_frac=0.5, **kw)
    torch.cuda.synchronize()
    out = _fed_out(frep)
    log("federated report, r1 killed at half the jobs: " + json.dumps(out))
    # the federation's own count, by job id: the survivor re-materializes
    # the victim's jobs, so the submitted objects of those stay RUNNING
    if not frep.drained or out["jobs"] != JOBS or out["done"] != JOBS \
            or out["failovers"] != 1:
        raise AssertionError(f"kill drill: {out}")
    if any(int(t.abs().sum()) for t in FD._counters.values()):
        raise AssertionError("a split-merge ticket was left set")

    # run 3: the chaos plan of seed 0
    jobs = _jobs(registry, "standard")
    plan = FaultPlan.generate(0, 2.0, ["r0", "r1", "r2"],
                              ["r0/accel", "r1/accel", "r2/accel"])
    log(f"chaos plan (seed 0, 2 s): {plan.to_json()}")
    torch.cuda.reset_peak_memory_stats()
    frep = eng.serve_jobs_federated(jobs, chaos_seed=0, chaos_horizon_s=2.0,
                                    **kw)
    torch.cuda.synchronize()
    out = _fed_out(frep)
    log("federated report, chaos seed 0: " + json.dumps(out))
    if not frep.drained or out["jobs"] != JOBS \
            or out["done"] + out["failed"] + out["cancelled"] != JOBS:
        raise AssertionError(f"chaos run: {out}")
    return counts


def main():
    smi = phase_card()
    dev = torch.device("cuda", 0)
    occ = phase_occupancy(dev)
    rows = phase_kernels(dev)
    counts = {}
    cfg, params = full_width_model(dev, "stablelm-1.6b")
    phase_reference(dev, cfg, params)
    counts["stablelm-1.6b"], main_out = phase_main(
        dev, cfg, params, {"flash_attention": cfg.n_layers},
        {"flash_decode": cfg.n_layers})
    phase_hetero(dev, main_out)
    counts["stablelm-1.6b queued"] = phase_queued(dev, cfg, params, smi)
    del params
    free_model()
    cfg, params = full_width_model(dev, "zamba2-1.2b")
    phase_reference_hybrid(dev, cfg, params)
    n_apps = cfg.n_layers // cfg.hybrid.attn_every
    counts["zamba2-1.2b"], _ = phase_main(
        dev, cfg, params,
        {"ssd_scan": cfg.n_layers, "flash_attention": n_apps},
        {"flash_decode": n_apps})
    # head dim 96 with a 144-row patch-embedding prefix, then GQA 8:1 at
    # head dim 128
    for arch in ("phi-3-vision-4.2b", "yi-6b"):
        del params
        free_model()
        cfg, params = full_width_model(dev, arch)
        phase_reference(dev, cfg, params)
        counts[arch], _ = phase_main(
            dev, cfg, params, {"flash_attention": cfg.n_layers},
            {"flash_decode": cfg.n_layers})
    counts["yi-6b federated"] = phase_federated(dev, cfg, params)
    sources = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:73"),
        "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:62"),
        "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:68"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        r = rows[name]
        by_path = {arch: c[name] for arch, c in counts.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_main_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "back_to_back_ms": r["back_to_back_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library_back_to_back_ms": r["library_back_to_back_ms"],
            "blocks_per_sm": {k: v for k, v in occ.items()
                              if k.startswith(name)},
            "shapes": r.get("shapes", {})})
    assert all(math.isfinite(k["ms"]) and k["launches"] > 0
               for k in kernels)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
