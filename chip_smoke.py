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
   gqa, d96, gqa8_d128, gqa2, and bulk64, phase 15a's chunk of 64; K2 at
   each model's decode: main, ragged, gqa, d96, gqa8_d128, b1, gqa2, and
   bulk64, every split count of its sweep held too; K3 at zamba2's): max
   abs error and tolerance, two times per
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
   ticket back at zero), and under the chaos plan of seed 0;
11. the MoE family: granite-moe-1b-a400m (24 layers, 32 experts top-8,
   16 query heads on 8 kv heads of 64) at full width with random weights
   from a torch.Generator seeded with 0, cut to 2 layers, and
   phi3.5-moe-42b-a6.6b (16 experts top-2, 32 query heads on 8 kv heads
   of 128) at full width with weights for its first 2 layers only: the
   kernels against their plain versions on the kernel run's routing
   (``phase_reference_moe``), with the share of routing picks a free run
   flips; then phase 4's main path on granite-moe-1b with 24
   flash-attention launches per prefill and 24 flash-decode launches per
   decode step, and the time of one chunk's prefill and decode step;
12. the xLSTM family: xlstm-350m (12 pairs of an mLSTM block, heads of
   512, and an sLSTM block, heads of 256) at full width with random
   weights from a torch.Generator seeded with 0, cut to its first pair:
   bf16 and fp32 on the card against the CPU (``phase_reference_xlstm``);
   then phase 4's main path with no launch of any kernel, and the time of
   one chunk's prefill and decode step;
13. training, with the serving models freed:
   a. flash-attention writing its row log-sum-exp L at phase 2's shapes
      main, gqa, d96, gqa8_d128 and gqa2: L against the plain version's,
      the output with L bit for bit the output without it, the device
      time with and without L, and with L back to back, beside
      ``aten._scaled_dot_product_flash_attention`` (output and L, the same
      function; timed only, on GQA's kv heads repeated);
   b. the attention backward: ``FlashAttentionFn`` forward and backward
      in bf16 at stablelm's training shape (b 8, S 512, H 32, D 64) and
      at gqa8_d128, dq/dk/dv against autograd through the plain version in
      fp32, timed (on the device alone, in a CUDA graph, and back to
      back), and beside it ``F.scaled_dot_product_attention`` forward and
      backward (timed only);
   c. stablelm-1.6b at full width cut to 2 layers, its block matrices at
      fan-in scale: one ``grad_step`` through the kernels in bf16 against
      the same step with the plain versions in their place, in bf16 and
      in fp32, leaf by leaf: every leaf finite, the kernels' run within
      5e-2 of the plain bf16 run and no farther from fp32 than 1.5 times
      the plain bf16 run's;
   d. the training main path: ``HeteroTrainer`` on full-width
      stablelm-1.6b (24 layers, random weights from a torch.Generator
      seeded with 0), group ``accel:chunk=8:async=2`` on cuda:0, seq_len
      512, global batch 32 of the same examples, 6 AdamW steps: the loss
      falls, every step covers 32 examples, flash-attention launches
      exactly 2 x 24 a chunk (the forward and the recompute) and no other
      kernel launches; time per step, tokens/s and peak memory, with one
      synchronise, at the end of the window;
   f. (run after d, on its weights) the update's ordering: three steps of
      stablelm-1.6b cut to 2 layers with no synchronise between them give
      the bits of the same steps synchronised after each;
   e. the heterogeneous training path on reduced stablelm-1.6b, groups
      ``accel:chunk=8:async=2`` on cuda:0 and ``cpu0``: every step covers
      the batch and the loss falls;
14. training the MoE, hybrid and xLSTM families:
   a. the SSD scan forward and backward (``SSDScanFn`` under a checkpoint,
      as training runs it: K3 exactly twice a call, the backward autograd
      through the plain version) in bf16 at zamba2's training shape (b 8,
      S 512, 64 heads, P = N = 64, chunks of 128): dx, ddt, dA, dB, dC
      against autograd through the plain version in fp32, timed on the
      device alone and back to back, beside the fp32 time and the bound;
   b. 13c's check for granite-moe-1b-a400m cut to 2 layers (the kernel
      run's routing replayed by the plain runs, and every recompute
      routing as its forward did), zamba2-1.2b cut to 7 layers (its first
      group and one tail block) and xlstm-350m cut to its first pair, each
      with its launches exact, and whether a second run repeats the bits;
   c. 13d's main path (random weights from a torch.Generator seeded with
      0) on full-width granite-moe-1b-a400m (24 layers; K1 2 x 24 a
      chunk; then one full-model step's recompute routing against its
      forward), zamba2-1.2b (38 layers; a chunk launches K3 2 x 36
      + 2, the tail blocks not being recomputed, and K1 2 x 6) and
      xlstm-350m (12 pairs, 3 steps of 16 examples of 256 tokens; no
      kernel launch);
15. the paper's core, run after phase 9 on phase 4's weights:
   a. the Bulk-Oracle baseline at full width: ``BulkScheduler.run(0, 64,
      1.0)`` over the engine's executor (group ``accel`` alone on cuda:0)
      on stablelm-1.6b, phase 4's 64 requests in one bulk chunk, so K1
      and K2 at b = 64: every request once, K1 exactly 24 and K2 24 x 15,
      every split ticket back at zero; beside it, warm, ``serve(64)``
      with ``accel:chunk=8:async=2`` (bulk, dynamic, bulk, dynamic), with
      wall time, tok/s, peak memory, the accel group's O_sp, O_hd, O_kl,
      O_td, O_dh, and energy and EDP modelled at the card's power limit,
      and the share of requests whose tokens equal across the two; then
      phase 3's check at b = 64 (the first 2 layers, 64 prompts of 512,
      kernels against plain versions, max |dlogit| <= 5e-2 max |logit|),
      and the bulk chunk of 64 once more with the plain versions, whose
      tokens are held beside the kernels' and the dynamic run's;
   b. the paper's comparison on phase 5's configuration (reduced
      stablelm-1.6b, accel on cuda:0 + cpu0 on the CPU, 64 x 128 + 16):
      ``BulkScheduler.oracle(0, 64)``, all eleven splits, each covering
      the 64 requests once with the accelerator given int(64 frac), the
      last 64 / 0, launches exact over the sweep, between two dynamic
      ``serve(64)`` runs; time, items and modelled EDP (cpu0 at 65 / 10
      W) a split, and dynamic normalised to the best split;
   c. ``examples/torch`` serve_hetero, observe and train_hetero_lm (20
      steps) on cuda:0 with their CPU groups on the CPU, their own
      assertions holding;
   d. the memory plan: for every architecture at full width, the bytes
      of its abstract parameters, AdamW state and each dry-run shape's
      inputs and caches (meta tensors), and stablelm-1.6b's abstract
      parameters against phase 4's materialised ones;
16. (run last, in a child process, so that no process group meets the
   phases before it) the sharding rules, the meshes and the dry run:
   a. the power limit against ``launch.mesh.CHIP_ACTIVE_W`` and the idle
      draw behind ``CHIP_IDLE_W``; ``make_group_meshes([1])`` on a real
      one-rank process group over cuda:0 (a FileStore in a temporary
      directory), one of phase 4's weights distributed on the (1, 1) mesh
      by the rules' placements, a DTensor product against the plain one;
   b. the dry-run CLI (``repro_torch.launch.dryrun``) on one cell per
      family at full width, each on the 16 x 16 and 2 x 16 x 16 fake
      meshes, every cell ok, with its bytes, FLOPs, collectives and
      trace seconds;
   c. the dry run of 13d's training chunk (stablelm-1.6b, 8 x 512, remat,
      AdamW) on a (1, 1) fake mesh: its argument bytes equal the bytes of
      the parameters, AdamW state and chunk of tokens and labels that
      13d's trainer holds on the card, and its argument plus temp bytes
      are printed beside 13d's measured peak.

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
    """(the least time in ms, what bounds it): the bytes over the card's
    memory rate and the FLOPs over its dense bf16 peak, the constants of
    ``repro_torch.launch.mesh``."""
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    t_bytes, t_ops = nbytes / HBM_BW, flops / PEAK_FLOPS_BF16
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
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD

    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev) \
            .to(torch.bfloat16)

    rows = {"flash_attention": {"shapes": {}}, "flash_decode": {"shapes": {}}}
    # K1 at the prefill shapes of the five attention models served (b=8),
    # causal, and at phase 15a's bulk chunk of 64
    fa_err = 0.0
    for name, b, sq, h, kvh, d in [("main", 8, 512, 32, 32, 64),
                                   ("ragged", 8, 1000, 32, 32, 64),
                                   ("gqa", 8, 512, 32, 8, 64),
                                   ("d96", 8, 656, 32, 32, 96),
                                   ("gqa8_d128", 8, 512, 32, 4, 128),
                                   ("gqa2", 8, 512, 16, 8, 64),
                                   ("bulk64", 64, 512, 32, 32, 64)]:
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
        nbytes = cost.attention_bytes(b, sq, sq, h, kvh, d)
        flops = cost.attention_flops(b, sq, sq, h, d)
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
    # and of phase 15a's bulk chunk of 64 (its 15 steps read 512-527 rows);
    # lens: every row's kv_len, or a range (lo, hi) to draw each from
    fd_err = 0.0
    for name, b, h, kvh, d, lens in [("main", 8, 32, 32, 64, 520),
                                     ("ragged", 8, 32, 32, 64, (1, 1025)),
                                     ("gqa", 8, 32, 8, 64, (1, 1025)),
                                     ("d96", 8, 32, 32, 96, 664),
                                     ("gqa8_d128", 8, 32, 4, 128, 520),
                                     ("b1", 1, 32, 32, 64, 520),
                                     ("gqa2", 8, 16, 8, 64, 520),
                                     ("bulk64", 64, 32, 32, 64, (512, 528))]:
        S = 1024
        q, kc, vc = rnd(b, 1, h, d), rnd(b, S, kvh, d), rnd(b, S, kvh, d)
        if isinstance(lens, int):
            kv_len = torch.full((b,), lens, dtype=torch.int32, device=dev)
        else:
            kv_len = torch.randint(*lens, (b,), generator=gen,
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
        nbytes = cost.decode_bytes(b, h, kvh, d, rows_read)
        flops = cost.decode_flops(rows_read, h, d)
        b_ms, b_by = bound(nbytes, flops)
        n_split = FD.split_count(
            b, kvh, S, torch.cuda.get_device_properties(dev)
            .multi_processor_count)
        # the device time at other split counts, for the split policy;
        # each count held against the plain version too
        sweep = {}
        for n in (1, 2, 4, 8, 16):
            got = FD.flash_decode(q, kc, vc, kv_len, n_split=n)
            d_err = (got.float() - exp.float()).abs().max().item()
            if not torch.allclose(got.float(), exp.float(), rtol=TOL,
                                  atol=TOL):
                raise AssertionError(f"flash_decode {name} n_split={n}: "
                                     f"max abs err {d_err}")
            fd_err = max(fd_err, d_err)
            sweep[n] = graph_ms(lambda: FD.flash_decode(q, kc, vc, kv_len,
                                                        n_split=n), 200)
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
    from repro_torch.kernels import cost
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
        # each input read once, each output written once
        nbytes = cost.ssd_bytes(b, s, nh, P, g, N, with_init)
        flops = cost.ssd_flops(b, s, nh, P, N, Q)
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


class _PlainAttentionFn:
    """``FlashAttentionFn``'s plain version: autograd through the plain
    flash-attention, in the grouped layout, neither the kernel nor the
    written-out backward."""

    @staticmethod
    def apply(q, k, v, causal, q_chunk, kv_chunk):
        from repro_torch.kernels.flash_attention import flash_attention_plain
        b, sq, g, m, hd = q.shape
        o = flash_attention_plain(q.reshape(b, sq, g * m, hd), k, v,
                                  causal=causal)
        return o.view(b, sq, g, m, hd)


class _PlainSSDScanFn:
    """``SSDScanFn``'s plain version: autograd through the plain SSD scan,
    neither the kernel nor the Function's recompute."""

    @staticmethod
    def apply(x, dt, A, B, C, chunk, init_state):
        from repro_torch.kernels.ssd_scan import ssd_scan_plain
        return ssd_scan_plain(x, dt, A, B, C, chunk, init_state)


class plain_kernels:
    """Within the block, the model calls the kernels' plain versions
    instead of the kernels, and trains through ``_PlainAttentionFn`` and
    ``_PlainSSDScanFn`` instead of ``FlashAttentionFn`` and ``SSDScanFn``
    (the reference runs of phases 3, 6, 13c and 14b)."""

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.kernels.flash_attention import flash_attention_plain
        from repro_torch.kernels.flash_decode import flash_decode_plain
        from repro_torch.kernels.ssd_scan import ssd_scan_plain
        from repro_torch.models import ssm, transformer
        self.ops, self.tfm, self.ssm = ops, transformer, ssm
        self.saved = (ops.attention_bshd, ops.decode_attention_bshd,
                      ops.ssd_bshn, transformer.FlashAttentionFn,
                      ssm.SSDScanFn)
        transformer.FlashAttentionFn = _PlainAttentionFn
        ssm.SSDScanFn = _PlainSSDScanFn
        ops.attention_bshd = lambda q, k, v, n_heads, n_kv_heads, causal, \
            q_offset=0, return_lse=False: flash_attention_plain(
                q, k, v, causal=causal, q_offset=q_offset,
                return_lse=return_lse)
        ops.decode_attention_bshd = lambda q, kc, vc, kv_len, n_heads, \
            n_kv_heads: flash_decode_plain(q, kc, vc, kv_len)
        ops.ssd_bshn = lambda x, dt, A, B, C, chunk, init_state: \
            ssd_scan_plain(x, dt, A, B, C, chunk, init_state)
        return self

    def __exit__(self, *exc):
        (self.ops.attention_bshd, self.ops.decode_attention_bshd,
         self.ops.ssd_bshn, self.tfm.FlashAttentionFn,
         self.ssm.SSDScanFn) = self.saved


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
    cfg2, params2 = first_blocks(2)(cfg, params)
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                           dtype=torch.int32).to(dev)
    prefix = None
    if cfg.prefix_len:
        prefix = (torch.randn(2, cfg.prefix_len, cfg.d_model, generator=gen)
                  * 0.02).to(dev)
    max_len = 128 + cfg.prefix_len
    _zero_launches()
    got, _ = greedy_run(cfg2, params2, tokens, max_len, prefix=prefix)
    counts = _launches()
    if counts != {"flash_attention": 2, "flash_decode": 8, "ssd_scan": 0}:
        raise AssertionError(f"the reference check's launches: {counts}")
    with plain_kernels():
        ref, _ = greedy_run(cfg2, params2, tokens, max_len, prefix=prefix)
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


def first_blocks(n_layers):
    """A cut for ``_fan_in_cut``: the first ``n_layers`` blocks."""
    return lambda cfg, params: (cfg.replace(n_layers=n_layers), dict(
        params, blocks=_map(lambda t: t[:n_layers], params["blocks"])))


def first_pair(cfg, params):
    """A cut for ``_fan_in_cut``: the xLSTM's first pair."""
    return cfg.replace(n_layers=cfg.xlstm.slstm_every), dict(
        params, m=_map(lambda t: t[:1], params["m"]),
        s=_map(lambda t: t[:1], params["s"]))


class no_tf32:
    """Within the block, fp32 matmuls and convolutions run in fp32, not
    TF32 (the fp32 reference runs)."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def greedy_run(cfg, params, prompt, max_len, forced=None, prefix=None):
    """Prefill ``prompt`` (after the modality ``prefix`` rows, if any)
    and 4 greedy decode steps, each fed its own greedy token or, given
    ``forced`` (5, b), the one of that step. Returns the 5 stacked logits
    (fp32) and the 5 greedy tokens."""
    from repro_torch.models import model as M
    prompt = prompt.to(params["embed"].device)
    out, toks = [], []
    with torch.no_grad():
        logits, cache = M.prefill(cfg, params, prompt, prefix,
                                  max_len=max_len)
        for step in range(5):
            out.append(logits.float())
            toks.append(logits[:, -1].argmax(-1).to(torch.int32))
            if step < 4:
                feed = toks[-1] if forced is None else \
                    forced[step].to(prompt.device)
                logits, cache = M.decode_step(cfg, params, cache,
                                              feed[:, None])
    return torch.stack(out), torch.stack(toks)


def hybrid_runs(dev, cfg, params, n_layers):
    """A 300-token prompt (b=2; two whole SSD chunks and a ragged third)
    and 4 greedy decode steps on ``hybrid_cut(n_layers)``, three ways: bf16
    through the kernels, bf16 through the kernels' plain versions, and
    fp32 (weights cast up) through the plain versions with TF32 off. The
    second and third runs are fed the first run's greedy tokens, so every
    step compares like with like. Returns the three stacked logits, the
    kernel run's launch counts and each run's greedy tokens."""
    cfg_n, params_n = hybrid_cut(cfg, params, n_layers)
    gen = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, (2, 300), generator=gen,
                           dtype=torch.int32).to(dev)
    _zero_launches()
    got, toks = greedy_run(cfg_n, params_n, prompt, 512)
    counts = _launches()
    with no_tf32(), plain_kernels():
        plain, plain_toks = greedy_run(cfg_n, params_n, prompt, 512, toks)
        ref, ref_toks = greedy_run(cfg_n.replace(dtype="float32"),
                                   _map(lambda t: t.float(), params_n),
                                   prompt, 512, toks)
    return (got, plain, ref), counts, (toks, plain_toks, ref_toks)


class routing:
    """Within the block, every MoE layer's router call (``moe._route``)
    is recorded in call order in ``self.calls``: (probs, gates, picked
    experts), and every capacity selection's tokens (``moe._capacity``,
    (E, slots)) in ``self.kept``. Given ``replay``, another run's
    ``routing``, each call takes that run's gates, picked experts and kept
    tokens for the same call instead of its own; the gates keep the
    gradient of the run's own (its renormalised router probabilities at
    the replayed picks), so that a backward still reaches the router."""

    def __init__(self, replay=None):
        self.replay, self.calls, self.kept = replay, [], []

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.saved = moe, (moe._route, moe._capacity)
        route, capacity = self.saved

        def recording_route(cfg, p, xf):
            probs, gates, picks = route(cfg, p, xf)
            if self.replay is not None:
                _, replayed, picks = self.replay.calls[len(self.calls)]
                top = probs.gather(1, picks)
                own = top / top.sum(-1, keepdim=True).clamp_min(1e-9)
                # the replayed values, with the gradient of the run's own
                gates = own + (replayed - own).detach()
            self.calls.append((probs, gates, picks))
            return probs, gates, picks

        def recording_capacity(cfg, prio):
            gates, tok = capacity(cfg, prio)
            if self.replay is not None:
                tok = self.replay.kept[len(self.kept)]
                gates = prio[tok, torch.arange(tok.shape[0],
                                               device=tok.device)[:, None]]
            self.kept.append(tok)
            return gates, tok

        moe._route, moe._capacity = recording_route, recording_capacity
        return self

    def __exit__(self, *exc):
        self.moe._route, self.moe._capacity = self.saved


def picks_differing(a, b) -> float:
    """Share of the (token, expert) picks of record ``a`` that record
    ``b`` did not make, over every router call of the two runs."""
    diff = total = 0
    for (probs, _, pa), (_, _, pb) in zip(a, b, strict=True):
        ma = torch.zeros_like(probs, dtype=torch.bool).scatter_(1, pa, True)
        mb = torch.zeros_like(probs, dtype=torch.bool).scatter_(1, pb, True)
        diff += int((ma & ~mb).sum())
        total += int(ma.sum())
    return diff / max(total, 1)


def recompute_differing(rec, n_layers):
    """For a grad_step recorded by ``routing`` (each layer's router called
    in the forward, then again in the backward's recompute, last layer
    first): the share of the forward's (token, expert) picks that the
    recompute did not make, and the same share of its capacity slots
    (the tokens each expert kept)."""
    fwd, again = rec.calls[:n_layers], rec.calls[n_layers:][::-1]
    slots = total = 0
    for a, b, (probs, _, _) in zip(rec.kept[:n_layers],
                                   rec.kept[n_layers:][::-1], fwd,
                                   strict=True):
        E, T = a.shape[0], probs.shape[0]
        ma = torch.zeros(E, T, dtype=torch.bool,
                         device=a.device).scatter_(1, a, True)
        mb = torch.zeros_like(ma).scatter_(1, b, True)
        slots += int((ma & ~mb).sum())
        total += int(ma.sum())
    return picks_differing(fwd, again), slots / max(total, 1)


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


def first_layers(dev, arch, n_layers):
    """``arch`` at full width with weights for its first ``n_layers``
    layers only (bf16, a torch.Generator seeded with 0). Stacked block
    weights are drawn with the full-depth model's stddev: the init takes
    fan-in from the leading (layer) axis (ROADMAP, "Fan-in of stacked
    weights"), so a 2-layer config drawn as such would get weights
    sqrt(full depth / 2) times larger than the model's first 2 layers."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.models.layers import init_from_defs
    cfg = get_config(arch)
    cut = cfg.replace(n_layers=n_layers)
    defs = M.param_defs(cut)
    shrink = math.sqrt(n_layers / cfg.n_layers)
    defs["blocks"] = _map(lambda d: d._replace(scale=d.scale * shrink),
                          defs["blocks"])
    t0 = time.perf_counter()
    params = init_from_defs(defs, torch.Generator(device=dev).manual_seed(0),
                            dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{arch}: {n_params} parameters for its first {n_layers} of "
        f"{cfg.n_layers} layers in {cfg.dtype}, init "
        f"{time.perf_counter() - t0:.2f} s")
    return cut, params


def phase_reference_moe(dev, cfg, params):
    """Phase 11's reference check: the MoE model at full width cut to 2
    layers (the first 2 of ``params``' blocks), a 64-token prompt (b=2)
    and 4 greedy decode steps; launches 2 of K1 and 8 of K2. The kernel
    run records its routing. Its plain-version run in bf16 is held against
    it as phase 3 holds the dense models, max |dlogit| <= 5e-2 * max
    |logit|, replaying the kernel run's routing (gates, picked experts
    and capacity slots). A pick flipped at a near-tie between two experts'
    probabilities, a discrete event that bf16 noise anywhere upstream can
    trigger, moves a token's output by a whole expert's share; on these
    random weights (stacked block weights of stddev 1/sqrt(layers),
    ROADMAP) expert outputs are large against the residual, so no bf16
    tolerance covers a flip. The flips are counted instead: a free-running
    plain bf16 run gives the share of picks that differ and its logits'
    distance, and an fp32 run (replaying the routing too) the bf16 runs'
    drift from fp32."""
    cfg2, params2 = first_blocks(2)(cfg, params)
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                           dtype=torch.int32).to(dev)
    _zero_launches()
    with routing() as rec:
        got, toks = greedy_run(cfg2, params2, prompt, 128)
    counts = _launches()
    if counts != {"flash_attention": 2, "flash_decode": 8, "ssd_scan": 0}:
        raise AssertionError(f"the reference check's launches: {counts}")
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite logits through the kernels")
    with no_tf32(), plain_kernels():
        with routing() as free:
            free_plain, _ = greedy_run(cfg2, params2, prompt, 128, toks)
        with routing(rec):
            plain, _ = greedy_run(cfg2, params2, prompt, 128, toks)
        with routing(rec):
            ref, ref_toks = greedy_run(
                cfg2.replace(dtype="float32"),
                _map(lambda t: t.float(), params2), prompt, 128, toks)
    rel = rel_err(got, plain)
    n_picks = sum(int(c[2].numel()) for c in rec.calls)
    log(f"reference check ({cfg.arch_id} widths, 2 layers, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, b=2, prompt 64, "
        f"4 decode steps, bf16): launches {json.dumps(counts)}; kernels vs "
        f"plain versions on the kernel run's routing: max |dlogit| / max "
        f"|logit| = {rel:.3e} (tol 5e-2); routing picks of a free plain "
        f"run differing from the kernel run's: "
        f"{picks_differing(rec.calls, free.calls):.4f} of {n_picks}, its "
        f"logits {rel_err(got, free_plain):.3e} from the kernel run's; from "
        f"the fp32 run on the same routing: kernels {rel_err(got, ref):.3e},"
        f" plain {rel_err(plain, ref):.3e}; greedy tokens equal to the fp32"
        f" run's {(toks == ref_toks).float().mean().item():.3f}")
    if rel > 5e-2:
        raise AssertionError(f"full-width MoE logits off: max rel err {rel}")


def phase_reference_xlstm(dev, cfg, params):
    """Phase 12's reference check: xlstm-350m at full width cut to its
    first pair (one mLSTM and one sLSTM block of the main path's weights),
    a 300-token prompt (b=2; two whole mLSTM chunks of 128 and a padded
    third) and 4 greedy decode steps, each run fed the card's bf16 run's
    tokens. No kernel is on this path: all three counts must be 0.

    - bf16 against fp32 on the card (weights cast up, TF32 off): the two
      differ by bf16 rounding alone, which random weights amplify by an
      amount that depends on the draw. So, as phase 6 holds zamba2, the
      card's bf16 run may be no farther from the fp32 run than 1.5 times
      the CPU's bf16 run of the same code on the same weights and inputs.
    - fp32 on the card against fp32 on the CPU (whose path
      tests/test_torch_xlstm.py holds against the JAX package): the same
      arithmetic in other summation orders and exp and log routines. fp32
      rounds 2^15 times finer than bf16, so the bf16 run's drift (logged,
      ~1e-2 of max |logit|) scaled down is ~3e-7; the bound, max |dlogit|
      <= 1e-4 * max |logit|, leaves room for reduction orders and
      transcendental routines to add 300 times that."""
    cfg1, params1 = first_pair(cfg, params)
    n = cfg1.n_layers
    gen = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, cfg.vocab, (2, 300), generator=gen,
                           dtype=torch.int32)
    cfg32 = cfg1.replace(dtype="float32")
    _zero_launches()
    got, toks = greedy_run(cfg1, params1, prompt.to(dev), 512)
    counts = _launches()
    if any(counts.values()):
        raise AssertionError(f"a kernel ran on the xLSTM path: {counts}")
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite xLSTM logits")
    cpu = torch.device("cpu")
    with no_tf32():
        ref, ref_toks = greedy_run(cfg32, _map(lambda t: t.float(), params1),
                                   prompt, 512, toks)
        p_cpu = _map(lambda t: t.to(cpu), params1)
        cpu_bf16, _ = greedy_run(cfg1, p_cpu, prompt, 512, toks)
        cpu_fp32, _ = greedy_run(cfg32, _map(lambda t: t.float(), p_cpu),
                                 prompt, 512, toks)
    ref = ref.cpu()
    err, err_cpu = rel_err(got.cpu(), ref), rel_err(cpu_bf16, ref)
    err32 = rel_err(ref, cpu_fp32)
    log(f"reference check (xlstm-350m widths, 1 pair = {n} layers, b=2, "
        f"prompt 300, 4 decode steps): launches {json.dumps(counts)}; max "
        f"|dlogit| / max |logit| from the card's fp32 run: card bf16 "
        f"{err:.3e}, CPU bf16 {err_cpu:.3e} (tol: card <= 1.5 x CPU = "
        f"{1.5 * err_cpu:.3e}); card fp32 vs CPU fp32 {err32:.3e} (tol "
        f"1e-4); greedy tokens equal to the fp32 run's "
        f"{(toks == ref_toks).float().mean().item():.3f}")
    if not err <= 1.5 * err_cpu:
        raise AssertionError(f"xLSTM bf16 on the card {err} from fp32, "
                             f"against the CPU's {err_cpu}")
    if not err32 <= 1e-4:
        raise AssertionError(f"xLSTM fp32 on the card off the CPU's: {err32}")


def one_chunk_times(dev, cfg, params, max_len):
    """The model's split of one main-path chunk (8 prompts of 512 tokens):
    the wall time of its prefill and of its 15 decode steps, each ended
    by a synchronise; the second of two runs is kept."""
    from repro_torch.models import model as M
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (8, 512), generator=gen,
                           dtype=torch.int32).to(dev)
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = M.prefill(cfg, params, tokens, max_len=max_len)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(15):
                tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                logits, cache = M.decode_step(cfg, params, cache, tok)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
    log(f"one chunk ({cfg.arch_id}, 8 x 512 prompt tokens, 15 decode "
        f"steps): " + json.dumps({"prefill_s": t1 - t0,
                                   "decode_step_s": (t2 - t1) / 15}))


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


# ---------------------------------------------------------------------------
# phase 13: training
# ---------------------------------------------------------------------------

#: the training main path: six AdamW steps on one repeated global batch,
#: a peak rate high enough for the loss to fall in six, one warmup step,
#: the cosine over the six
TRAIN_OC = dict(lr=1e-3, warmup_steps=1, total_steps=6)
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 6, 512, 32
#: phase 14c's cuts, to keep its run under a minute: xlstm-350m, whose
#: sLSTM scans one token at a time (12-19 s a chunk of 8 x 512 trained),
#: takes 3 steps of 16 examples of 256 tokens
XLSTM_TRAIN_STEPS, XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ = 3, 16, 256
#: L against the plain version's fp32 logsumexp, as torch.allclose: both
#: sum fp32 exponentials of the same fp32 products
LSE_TOL = 1e-4
#: the bf16 attention backward against fp32 autograd, max |diff| over the
#: reference's max |value|: bf16 rounds o, do and each gradient
BWD_TOL = 2e-2
#: 13c, each leaf's bf16 gradient through the kernels against the same step
#: with the plain versions in bf16, max |diff| over the plain max |value|
TRAIN_GRAD_TOL = 5e-2
#: 14a, the SSD scan's bf16 gradients against fp32 autograd, max |diff| over
#: the reference's max |value|: bf16 rounds dy, the three intermediates the
#: forward rounds (as the JAX package does) and dx, dB, dC
SSD_BWD_TOL = 2e-2


def phase_lse(dev):
    """13a: K1 asked for its row log-sum-exp at phase 2's shapes, timed on
    the device alone and back to back beside the PyTorch call that
    computes the same function, ``aten._scaled_dot_product_flash_attention``
    (output and row log-sum-exp; the port never calls it), fed the (b, h,
    s, d) layout it takes, with GQA's kv heads repeated to every query head
    outside the timing."""
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = {}
    for name, sq, h, kvh, d in [("main", 512, 32, 32, 64),
                                ("gqa", 512, 32, 8, 64),
                                ("d96", 656, 32, 32, 96),
                                ("gqa8_d128", 512, 32, 4, 128),
                                ("gqa2", 512, 16, 8, 64)]:
        b = 8
        q, k, v = (torch.randn(b, sq, n, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for n in (h, kvh, kvh))
        out = FA.flash_attention(q, k, v, causal=True)
        out_l, lse = FA.flash_attention(q, k, v, causal=True,
                                        return_lse=True)
        _, lse_ref = FA.flash_attention_plain(q, k, v, causal=True,
                                              return_lse=True)
        torch.cuda.synchronize()
        if not torch.equal(out, out_l):
            raise AssertionError(f"flash_attention {name}: the output with "
                                 f"L differs from the output without it")
        err = (lse - lse_ref).abs().max().item()
        if not torch.allclose(lse, lse_ref, rtol=LSE_TOL, atol=LSE_TOL):
            raise AssertionError(f"flash_attention {name}: L max abs err "
                                 f"{err}")
        ms = graph_ms(lambda: FA.flash_attention(q, k, v, causal=True), 50)
        ms_l, b2b_l = times(lambda: FA.flash_attention(
            q, k, v, causal=True, return_lse=True), 50)
        qt = q.transpose(1, 2)
        kt, vt = (x.transpose(1, 2).repeat_interleave(h // kvh, dim=1)
                  for x in (k, v))

        def sdpa():
            return torch.ops.aten._scaled_dot_product_flash_attention(
                qt, kt, vt, 0.0, True)[:2]

        lib_o, lib_l = sdpa()
        lib_err = max((lib_o.transpose(1, 2).float() - out.float()).abs()
                      .max().item(), (lib_l - lse).abs().max().item())
        lib_ms, lib_b2b = times(sdpa, 50)
        plain_ms = cuda_ms(lambda: FA.flash_attention_plain(
            q, k, v, causal=True, return_lse=True), 5)
        nbytes = cost.attention_bytes(b, sq, sq, h, kvh, d, lse=True)
        flops = cost.attention_flops(b, sq, sq, h, d)
        b_ms, b_by = bound(nbytes, flops)
        log(f"flash_attention with L {name}: b={b} S={sq} H={h} KVH={kvh} "
            f"D={d} L max_abs_err={err:.3e} (tol |diff| <= {LSE_TOL} + "
            f"{LSE_TOL} |plain|), output bit-equal without L; ms with "
            f"L={ms_l:.4f} (back to back {b2b_l:.4f}) without={ms:.4f} "
            f"plain_ms={plain_ms:.4f} sdpa_with_lse_ms={lib_ms:.4f} (back to back {lib_b2b:.4f}; "
            f"max |diff| from K1's o and L {lib_err:.3e}) "
            f"bound_ms={b_ms:.4f} ({b_by})")
        rows[name] = dict(ms=ms_l, back_to_back_ms=b2b_l, ms_without_lse=ms,
                          plain_ms=plain_ms, library_ms=lib_ms, library_back_to_back_ms=lib_b2b,
                          library_max_abs_diff=lib_err, bound_ms=b_ms,
                          bound_by=b_by, max_abs_err=err)
    return rows


def phase_attention_backward(dev):
    """13b: FlashAttentionFn forward + backward in bf16 against autograd
    through the plain version in fp32, and its time beside SDPA's."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.attention import (FlashAttentionFn,
                                              group_query_heads)
    gen = torch.Generator(device=dev).manual_seed(14)
    rows = {}
    for name, h, kvh, d in [("stablelm", 32, 32, 64),
                            ("gqa8_d128", 32, 4, 128)]:
        b, S = 8, 512
        q, k, v, do = (torch.randn(b, S, n, d, generator=gen, device=dev)
                       .to(torch.bfloat16) for n in (h, kvh, kvh, h))

        def fwd_bwd():
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            o = FlashAttentionFn.apply(group_query_heads(qg, kvh), kg, vg,
                                       True, 512, 1024)
            return (o.reshape(b, S, h, d),) + torch.autograd.grad(
                o, (qg, kg, vg), group_query_heads(do, kvh))

        def plain_fwd_bwd():
            qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
            o = FA.flash_attention_plain(qf, kf, vf, causal=True)
            return (o,) + torch.autograd.grad(o, (qf, kf, vf), do.float())

        def sdpa_fwd_bwd():
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=h != kvh)
            return torch.autograd.grad(o, (qt, kt, vt), do.transpose(1, 2))

        got = fwd_bwd()
        with no_tf32():
            ref = plain_fwd_bwd()
        errs = {n: rel_err(g.float(), r)
                for n, g, r in zip(("o", "dq", "dk", "dv"), got, ref)}
        del got, ref
        if not max(errs.values()) <= BWD_TOL:
            raise AssertionError(f"attention backward {name}: {errs}")
        ms, b2b_ms = times(fwd_bwd, 5)
        with no_tf32():
            plain_ms = cuda_ms(plain_fwd_bwd, 3)
        lib_ms, lib_b2b_ms = times(sdpa_fwd_bwd, 20)
        # the least work of causal attention forward + backward: two
        # products forward, five backward, over the causal triangle; q, k,
        # v read forward and backward, o and L written then read, do read,
        # dq, dk, dv written
        q_el, kv_el = b * S * h * d, b * S * kvh * d
        flops = 7 * 2 * b * h * d * (S * (S + 1) // 2)
        nbytes = 2 * (2 * (q_el + 2 * kv_el) + 3 * q_el + q_el
                      + 2 * kv_el) + 2 * 4 * b * h * S
        b_ms, b_by = bound(nbytes, flops)
        log(f"attention forward + backward {name}: b={b} S={S} H={h} "
            f"KVH={kvh} D={d} bf16, max |diff| / max |fp32 autograd|: "
            + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + f" (tol {BWD_TOL}); ms={ms:.4f} (back to back {b2b_ms:.4f}) "
            f"plain_fp32_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} (back to "
            f"back {lib_b2b_ms:.4f}) bound_ms={b_ms:.4f} ({b_by})")
        rows[name] = dict(ms=ms, back_to_back_ms=b2b_ms, plain_ms=plain_ms,
                          library_ms=lib_ms,
                          library_back_to_back_ms=lib_b2b_ms,
                          bound_ms=b_ms, bound_by=b_by, rel_err=errs)
    return rows


def _named_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named_leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, tree[k]


def _train_batch(dev, cfg, n):
    from repro_torch.data.pipeline import for_model
    batch = for_model(cfg, TRAIN_SEQ - cfg.prefix_len, 0).batch(0, n)
    return {k: torch.from_numpy(a).to(dev) for k, a in batch.items()}


#: the stacked weight collections of each family and their stack axes
#: (``models.layers`` draws a stacked matrix at the fan-in of its leading
#: axis)
STACKS = {"blocks": 1, "groups": 2, "tail": 1, "m": 2, "s": 1}


def _fan_in_cut(cfg, params, cut):
    """``cut(cfg, params)`` with each stacked block matrix scaled to
    stddev 1/sqrt(d_model). Drawn at the fan-in of its stacked shape
    (stddev 1/sqrt(leading axis), as the JAX package draws it) a block
    matrix gives attention scores of stddev ~85, so attention is all but
    one-hot and a row's bf16 gradient is the rounding of o in delta =
    sum(do * o), as large as the gradient itself; at this scale it is
    not. The factor is taken from the uncut stack."""
    scale = {k: math.sqrt(next(_leaves(params[k])).shape[0] / cfg.d_model)
             for k in STACKS if k in params}
    cfg_c, params_c = cut(cfg, params)
    return cfg_c, {k: _map(lambda t, k=k: t * scale[k]
                           if t.dim() >= STACKS[k] + 2 else t, v)
                   if k in scale else v for k, v in params_c.items()}


def phase_train_reference(dev, cfg, params, cut, want):
    """13c and 14b: one grad_step of the model at full width, cut by
    ``_fan_in_cut(cut)`` from the main path's weights, 4 sequences of 512
    tokens, through the kernels, ``FlashAttentionFn`` and ``SSDScanFn`` in
    bf16 (launches ``want``), against the same step with their plain
    versions in their place (``plain_kernels``: the backwards are
    autograd's) in bf16, and in fp32 (TF32 off). Each leaf's gradient
    through the kernels finite, within TRAIN_GRAD_TOL of the plain bf16
    one and at most 1.5 times as far from the fp32 one as the plain bf16
    one (max |diff| / max |reference|); the loss within 1e-3 of the fp32
    loss, relative (bf16 logits, averaged over 2,048 tokens).

    An MoE model's kernel run records its routing, forward and recompute
    (``routing``); its recompute must pick the forward's experts and
    capacity slots (share differing: 0), and both plain runs replay that
    routing (phase 11 says why). A second kernel run of the same step
    tells whether the step repeats its bits (logged)."""
    from repro_torch.train.train_step import grad_step
    cfg_c, params_c = _fan_in_cut(cfg, params, cut)
    batch = _train_batch(dev, cfg, 4)
    moe = cfg.moe is not None
    _zero_launches()
    with routing() as rec:
        got, m_got = grad_step(cfg_c, params_c, batch)
    counts = _launches()
    if counts != want:
        raise AssertionError(f"the training reference check's launches: "
                             f"{counts}, expected {want}")
    again, _ = grad_step(cfg_c, params_c, batch)
    same_bits = sum(torch.equal(a, b) for a, b in zip(_leaves(got),
                                                      _leaves(again)))
    del again
    replay = rec if moe else None
    with plain_kernels():
        with routing(replay):
            plain, m_plain = grad_step(cfg_c, params_c, batch)
        with no_tf32(), routing(replay):
            ref, m_ref = grad_step(cfg_c.replace(dtype="float32"),
                                   _map(lambda t: t.float(), params_c),
                                   batch)
    dist = {}
    for (name, g), (_, p), (_, r) in zip(_named_leaves(got),
                                         _named_leaves(plain),
                                         _named_leaves(ref)):
        if not torch.isfinite(g).all():
            raise AssertionError(f"non-finite gradient {name}")
        dist[name] = {"kernels_plain": rel_err(g.float(), p.float()),
                      "kernels_fp32": rel_err(g.float(), r),
                      "plain_fp32": rel_err(p.float(), r)}
    losses = {k: m["loss"].item() for k, m in
              (("kernels", m_got), ("plain", m_plain), ("fp32", m_ref))}
    out = {"losses": losses, "launches": counts,
           "leaves_bit_equal_on_a_second_run": f"{same_bits} of {len(dist)}"}
    if moe:
        picks, slots = recompute_differing(rec, cfg_c.n_layers)
        out["recompute_differing"] = {"picks": picks, "capacity_slots": slots}
    log(f"training reference check ({cfg.arch_id} widths, "
        f"{cfg_c.n_layers} layers at fan-in scale, b=4, S={TRAIN_SEQ}): "
        f"{json.dumps(out)} (tol: kernels' loss within 1e-3 of fp32, "
        f"relative; recompute differing 0); gradient max |diff| / max "
        f"|reference| per leaf (tol: kernels_plain <= {TRAIN_GRAD_TOL}, "
        f"kernels_fp32 <= 1.5 x plain_fp32): " + json.dumps(dist))
    off = [n for n, d in dist.items()
           if not (d["kernels_plain"] <= TRAIN_GRAD_TOL
                   and d["kernels_fp32"] <= 1.5 * d["plain_fp32"])]
    if off or not abs(losses["kernels"] - losses["fp32"]) \
            <= 1e-3 * abs(losses["fp32"]):
        raise AssertionError(f"training step off: leaves {off}, losses "
                             f"{losses}")
    if moe and (picks or slots):
        raise AssertionError(f"the recompute routed otherwise than the "
                             f"forward: {out['recompute_differing']}")
    out["grad_rel_dist"] = dist
    return out


def phase_train_ordering(dev, cfg, params):
    """13f: the weight update and the next step's chunks run on two
    streams, ordered by an event and not by the host. Three steps of the
    model cut to 2 layers, with no synchronise between them, give the same
    losses and weights, bit for bit, as the same steps with a synchronise
    after each."""
    from repro_torch.core.types import DeviceKind
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import GroupDef, HeteroTrainer
    cfg2, params2 = first_blocks(2)(cfg, params)

    def run(sync):
        tr = HeteroTrainer(
            cfg2, [GroupDef("accel", DeviceKind.ACCEL, device=dev,
                            fixed_chunk=4, async_depth=2)],
            seq_len=256, global_batch=8,
            oc=OptConfig(lr=1e-3, warmup_steps=1, total_steps=3),
            repeat_data=True, params=_map(torch.clone, params2))
        losses = []
        for _ in range(3):
            losses.append(tr.train_step().loss)
            if sync:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        return losses, _leaves(tr.params)

    loss_sync, w_sync = run(True)
    loss_free, w_free = run(False)
    same = [torch.equal(a, b) for a, b in zip(w_free, w_sync)]
    log(f"training step ordering ({cfg.arch_id} widths, 2 layers, 3 steps): "
        f"losses synchronised {loss_sync}, not {loss_free}; "
        f"{sum(same)} of {len(same)} weight leaves bit-equal")
    if loss_free != loss_sync or not all(same):
        raise AssertionError("steps without a host synchronise differ from "
                             "the synchronised ones")


def phase_train_main(dev, cfg, params, per_chunk, steps=TRAIN_STEPS,
                     seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH):
    """13d and 14c: the training main path on ``params`` (a full-width
    model): ``HeteroTrainer``, group ``accel:chunk=8:async=2``, ``steps``
    AdamW steps on one repeated global batch; launches must equal
    ``per_chunk[k]`` a chunk for each kernel k."""
    from repro_torch.core.types import DeviceKind
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import GroupDef, HeteroTrainer
    groups = [GroupDef("accel", DeviceKind.ACCEL, device=dev, fixed_chunk=8,
                       async_depth=2)]
    oc = dict(TRAIN_OC, total_steps=steps)
    tr = HeteroTrainer(cfg, groups, seq_len=seq_len,
                       global_batch=global_batch, oc=OptConfig(**oc),
                       seed=0, repeat_data=True, params=params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    records = []
    start = t0 = time.perf_counter()
    for _ in range(steps):
        # no synchronise inside the window: a step's update overlaps the
        # next step's dispatch, as in any run of the trainer
        rep = tr.train_step()
        t1 = time.perf_counter()
        records.append({"step": rep.step, "loss": rep.loss,
                        "examples": rep.examples,
                        "items": rep.per_group_items, "host_s": t1 - t0,
                        "sched_s": rep.time_s,
                        "chunks": rep.overheads["accel"]["n_chunks"]})
        t0 = t1
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    counts = _launches()
    chunks = sum(r["chunks"] for r in records)
    want = {k: chunks * per_chunk.get(k, 0) for k in counts}
    out = {"steps": records, "chunks": chunks, "launches": counts,
           "wall_s": wall_s, "s_per_step": wall_s / steps,
           "tok_per_s": sum(r["examples"] for r in records) * seq_len
           / wall_s,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "opt": oc, "seq_len": seq_len, "global_batch": global_batch}
    log(f"training main path report ({cfg.arch_id}): " + json.dumps(out))
    del tr
    if any(r["examples"] != global_batch
           or sum(r["items"].values()) != global_batch for r in records):
        raise AssertionError(f"a step did not cover {global_batch} examples")
    if not all(math.isfinite(r["loss"]) for r in records) \
            or not records[-1]["loss"] < records[0]["loss"]:
        raise AssertionError(f"the loss did not fall: "
                             f"{[r['loss'] for r in records]}")
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    return counts, out


def phase_recompute_routing(dev, cfg, params):
    """14c, after granite-moe's main path: one grad_step of the full model
    on one chunk (8 x 512) with its routing recorded; every layer's
    recompute must pick the forward's experts and capacity slots."""
    from repro_torch.train.train_step import grad_step
    with routing() as rec:
        grad_step(cfg, params, _train_batch(dev, cfg, 8))
    picks, slots = recompute_differing(rec, cfg.n_layers)
    log(f"recompute routing ({cfg.arch_id}, {cfg.n_layers} layers, 8 x "
        f"{TRAIN_SEQ}): share of the forward's picks the recompute did not "
        f"make {picks}, of its capacity slots {slots} (tol 0)")
    if picks or slots:
        raise AssertionError(f"the recompute routed otherwise: {picks}, "
                             f"{slots}")
    return {"picks": picks, "capacity_slots": slots}


def phase_ssd_backward(dev):
    """14a: the SSD scan forward and backward in bf16 at zamba2's training
    shape (b 8, s 512, 64 heads, P = N = 64, one group, chunks of 128),
    as training runs it: ``SSDScanFn`` under a checkpoint, so K3 runs
    twice a call (forward and recompute), and the backward differentiates
    the plain version. dx, ddt, dA, dB and dC against autograd through the
    plain version in fp32 (TF32 off), max |diff| / max |reference| <=
    SSD_BWD_TOL; timed on the device alone (a CUDA graph) and back to
    back, beside the fp32 autograd time and the bound."""
    from repro_torch.kernels import cost
    import torch.nn.functional as F
    from torch.utils.checkpoint import checkpoint
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models.ssm import SSDScanFn
    gen = torch.Generator(device=dev).manual_seed(15)
    b, s, nh, P, N, g, Q = 8, 512, 64, 64, 64, 1, 128
    conv = (torch.randn(b, s, nh * P + 2 * g * N, generator=gen,
                        device=dev) * 0.5).to(torch.bfloat16)
    dt = F.softplus(torch.randn(b, s, nh, generator=gen, device=dev))
    A = -torch.exp(torch.randn(nh, generator=gen, device=dev) * 0.3)
    dy = (torch.randn(b, s, nh, P, generator=gen, device=dev) * 0.1) \
        .to(torch.bfloat16)

    def split(t):
        return (t[..., :nh * P].unflatten(-1, (nh, P)),
                t[..., nh * P:nh * P + g * N].unflatten(-1, (g, N)),
                t[..., nh * P + g * N:].unflatten(-1, (g, N)))

    def grads(fn, conv, dt, A, dy):
        leaves = [t.detach().requires_grad_() for t in (conv, dt, A)]
        x, B, C = split(leaves[0])
        y = fn(x, leaves[1], leaves[2], B, C)
        dconv, ddt, dA = torch.autograd.grad(y, leaves, dy)
        dx, dB, dC = split(dconv)
        return {"dx": dx, "ddt": ddt, "dA": dA, "dB": dB, "dC": dC}

    def fwd_bwd():
        return grads(lambda *a: checkpoint(
            lambda *a: SSDScanFn.apply(*a, Q, None)[0], *a,
            use_reentrant=False), conv, dt, A, dy)

    def plain_fwd_bwd():
        return grads(lambda *a: SSD.ssd_scan_plain(*a, Q)[0], conv.float(),
                     dt, A, dy.float())

    _zero_launches()
    got = fwd_bwd()
    torch.cuda.synchronize()
    launches = _launches()["ssd_scan"]
    if launches != 2:
        raise AssertionError(f"ssd_scan forward + backward launched K3 "
                             f"{launches} times, expected 2")
    with no_tf32():
        ref = plain_fwd_bwd()
    errs = {k: rel_err(got[k].float(), ref[k]) for k in got}
    bad = [k for k, v in got.items()
           if v.dtype != {"ddt": dt, "dA": A}.get(k, conv).dtype
           or not torch.isfinite(v).all()]
    del got, ref
    if bad or not max(errs.values()) <= SSD_BWD_TOL:
        raise AssertionError(f"ssd_scan backward: {errs}, dtype or finite "
                             f"off: {bad}")
    ms, b2b_ms = times(fwd_bwd, 5)
    with no_tf32():
        plain_ms = cuda_ms(plain_fwd_bwd, 3)
    # the least work: the forward's products once and their backward, two
    # products for each; x, B, C, dt, A and dy read once, y never stored,
    # dx, dB, dC, ddt and dA written once
    flops = 3 * cost.ssd_flops(b, s, nh, P, N, Q)
    nbytes = 2 * 2 * (b * s * nh * P + 2 * b * s * g * N) \
        + 2 * b * s * nh * P + 2 * 4 * (b * s * nh + nh)
    b_ms, b_by = bound(nbytes, flops)
    log(f"ssd_scan forward + backward (training, checkpointed): b={b} S={s} "
        f"nh={nh} P={P} N={N} g={g} Q={Q} bf16, K3 launches a call "
        f"{launches}; max |diff| / max |fp32 autograd|: "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (tol {SSD_BWD_TOL}); ms={ms:.4f} (back to back {b2b_ms:.4f}) "
        f"plain_fp32_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}; "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); no PyTorch call "
        f"computes the scan")
    return dict(ms=ms, back_to_back_ms=b2b_ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by, rel_err=errs,
                launches_a_call=launches)


def phase_train_hetero(dev):
    """13e: the heterogeneous training path on reduced stablelm (bf16)."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import DeviceKind
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import GroupDef, HeteroTrainer
    cfg = reduced(get_config("stablelm-1.6b"))
    groups = [GroupDef("accel", DeviceKind.ACCEL, device=dev, fixed_chunk=8,
                       async_depth=2),
              GroupDef("cpu0", DeviceKind.BIG, device=torch.device("cpu"))]
    tr = HeteroTrainer(cfg, groups, seq_len=128, global_batch=32,
                       oc=OptConfig(lr=1e-3, warmup_steps=1, total_steps=4),
                       seed=0, repeat_data=True)
    _zero_launches()
    reps = tr.train(4)
    counts = _launches()
    accel_chunks = sum(r.overheads.get("accel", {}).get("n_chunks", 0)
                       for r in reps)
    out = {"losses": [r.loss for r in reps],
           "examples": [r.examples for r in reps],
           "items": [r.per_group_items for r in reps],
           "failed": [r.failed_groups for r in reps], "launches": counts}
    log("heterogeneous training report (reduced stablelm-1.6b): "
        + json.dumps(out))
    if any(r.examples != 32 or sum(r.per_group_items.values()) != 32
           or r.failed_groups for r in reps):
        raise AssertionError("work not conserved")
    if not reps[-1].loss < reps[0].loss:
        raise AssertionError(f"the loss did not fall: {out['losses']}")
    if counts != {"flash_attention": accel_chunks * 2 * cfg.n_layers,
                  "flash_decode": 0, "ssd_scan": 0}:
        raise AssertionError(f"kernel launches {counts} for {accel_chunks} "
                             f"accel chunks")


# ---------------------------------------------------------------------------
# phase 15: the paper's core (Bulk-Oracle against Dynamic, the examples on
# the card, the memory plan)
# ---------------------------------------------------------------------------

OVERHEADS = ("O_sp", "O_hd", "O_kl", "O_td", "O_dh", "kernel_frac",
             "n_chunks")
#: cpu0's modelled power (active, idle W), the README's ``--power`` example
CPU_POWER_W = (65.0, 10.0)
BULK_REQUESTS = 64


def _energy_model(watts, groups):
    from repro_torch.core.energy import EnergyModel, PowerSpec
    specs = {"accel": PowerSpec(active_w=watts, idle_w=0.0)}
    if "cpu0" in groups:
        specs["cpu0"] = PowerSpec(*CPU_POWER_W)
    return EnergyModel(specs)


def _run_out(time_s, overheads, energy, new_tokens, items):
    """One run's line: wall time, tok/s, peak memory, the accel group's
    offload fractions, and energy and EDP modelled from each group's
    device-busy seconds (tg1 -> tg5 summed over its chunks: the fractions
    O_hd + O_kl + kernel + O_dh of the wall time)."""
    busy = {g: time_s * sum(ov.get(k, 0.0) for k in
                            ("O_hd", "O_kl", "kernel_frac", "O_dh"))
            for g, ov in overheads.items() if g != "all"}
    rep = energy.energy(time_s, busy)
    return {"time_s": time_s, "tok_per_s": new_tokens / max(time_s, 1e-9),
            "items": items,
            "accel_overheads": {k: overheads.get("accel", {}).get(k, 0.0)
                                for k in OVERHEADS},
            "busy_s": busy, "energy_j": rep.total_j, "edp_js": rep.edp,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def _bulk_scheduler(eng):
    """``BulkScheduler`` over the engine's own executors."""
    from repro_torch.core import BulkScheduler, GroupSpec
    return BulkScheduler(
        {g.name: GroupSpec(g.name, g.kind) for g in eng.groups},
        {g.name: eng._executor_for(g) for g in eng.groups})


def _bulk_out(eng, res, energy):
    """Checks one bulk run (every request once, the accelerator's share
    int(n * frac), tokens in the vocabulary) and reports it."""
    from repro_torch.core import OverheadLedger
    n = BULK_REQUESTS
    covered = sorted(i for r in res.records
                     for i in range(r.token.chunk.begin, r.token.chunk.end))
    if covered != list(range(n)):
        raise AssertionError(f"bulk frac {res.frac}: requests covered "
                             f"{covered}")
    if res.per_group_items.get("accel", 0) != int(n * res.frac):
        raise AssertionError(f"bulk frac {res.frac}: accel got "
                             f"{res.per_group_items}")
    tokens = {}
    for r in res.records:
        # a chunk's batch is padded to a power of two: its first rows
        out = r.meta["result"]["tokens_out"][:r.token.chunk.size]
        if out.shape != (r.token.chunk.size, eng.decode_tokens) \
                or out.min() < 0 or out.max() >= eng.cfg.vocab:
            raise AssertionError(f"bulk chunk {r.token.chunk}: bad tokens")
        for i in range(r.token.chunk.size):
            tokens[r.token.chunk.begin + i] = out[i]
    ledger = OverheadLedger()
    ledger.add_many(res.records)
    overheads = {g.name: ledger.report(res.total_time, g.name)
                 for g in eng.groups}
    out = _run_out(res.total_time, overheads, energy,
                   n * eng.decode_tokens, dict(res.per_group_items))
    out["frac"] = res.frac
    return out, tokens


def _dynamic_out(eng, energy):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    rep = eng.serve(BULK_REQUESTS)
    counts = _launches()
    torch.cuda.synchronize()
    if rep.requests != BULK_REQUESTS \
            or sorted(rep.tokens_out) != list(range(BULK_REQUESTS)):
        raise AssertionError(f"dynamic run incomplete: {rep}")
    out = _run_out(rep.time_s, rep.overheads, energy, rep.new_tokens,
                   dict(rep.per_group_items))
    out["launches"] = counts
    return out, rep.tokens_out


def phase_bulk_full_width(dev, cfg, params, watts):
    """15a: ``BulkScheduler.run(0, 64, 1.0)`` over the engine's executor
    (group ``accel`` alone on cuda:0, ``async_depth=2``) on full-width
    stablelm-1.6b (phase 4's weights), 64 requests of 512 prompt + 16
    decode tokens in one bulk chunk, max_len 1024: K1 and K2 at b = 64.
    Beside it, warm, ``serve(64)`` with ``accel:chunk=8:async=2`` on the
    same engine: bulk, dynamic, bulk, dynamic, after one bulk warm-up.
    Launches exact for every run, every split ticket back at zero."""
    from repro_torch.core.types import DeviceKind
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.serve.engine import GroupDef, HeteroServeEngine
    energy = _energy_model(watts, ())
    eng = HeteroServeEngine(
        cfg, [GroupDef("accel", DeviceKind.ACCEL, device=dev, fixed_chunk=8,
                       async_depth=2)],
        prompt_len=JOB_PROMPT, decode_tokens=JOB_DECODE, seed=0,
        params=params)
    bulk = _bulk_scheduler(eng)
    _bulk_out(eng, bulk.run(0, BULK_REQUESTS, 1.0), energy)    # warm-up
    runs, tokens = {"bulk": [], "dynamic": []}, {}
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        res = bulk.run(0, BULK_REQUESTS, 1.0)
        bulk_counts = _launches()
        torch.cuda.synchronize()
        out, tokens["bulk"] = _bulk_out(eng, res, energy)
        out["launches"] = bulk_counts
        _expect_launches(bulk_counts, 1, cfg.n_layers)
        if any(int(t.abs().sum()) for t in FD._counters.values()):
            raise AssertionError("a split-merge ticket was left set")
        runs["bulk"].append(out)
        out, tokens["dynamic"] = _dynamic_out(eng, energy)
        _expect_launches(out["launches"],
                         out["accel_overheads"]["n_chunks"], cfg.n_layers)
        runs["dynamic"].append(out)
    log(f"15a bulk frac 1.0 against dynamic ({cfg.arch_id}, full width, "
        f"64 x {JOB_PROMPT} + {JOB_DECODE}, energy {MODELLED}, "
        f"{watts} W): " + json.dumps(runs))
    bulk_reference(dev, cfg, params)
    # the bulk chunk once more with the plain versions in the kernels'
    # place: the witness for how far bf16 alone moves the greedy tokens
    _zero_launches()
    with plain_kernels():
        res = bulk.run(0, BULK_REQUESTS, 1.0)
    if sum(_launches().values()):
        raise AssertionError(f"plain bulk run launched {_launches()}")
    tokens["plain bulk"] = _bulk_out(eng, res, energy)[1]

    def same(a, b):
        """Share of requests whose 16 tokens are all equal, share whose
        first (the prefill's) is, and the mean index of the first token
        that differs (16 where none does)."""
        first = []
        for i in range(BULK_REQUESTS):
            d = torch.as_tensor(tokens[a][i] != tokens[b][i]).nonzero()
            first.append(int(d[0]) if len(d) else JOB_DECODE)
        return (f"{sum(f == JOB_DECODE for f in first) / BULK_REQUESTS:.4f}"
                f" (first token {sum(f > 0 for f in first) / BULK_REQUESTS:.4f}"
                f", first difference at {sum(first) / BULK_REQUESTS:.2f})")
    log(f"15a requests whose 16 tokens are equal (bf16: reported, not "
        f"asserted): bulk vs dynamic (b 64 vs 8, kernels) "
        f"{same('bulk', 'dynamic')}, bulk vs plain bulk (b 64, kernels vs "
        f"plain versions) {same('bulk', 'plain bulk')}, plain bulk vs "
        f"dynamic {same('plain bulk', 'dynamic')}")
    return runs["bulk"][0]["launches"]


def bulk_reference(dev, cfg, params):
    """Phase 3's check at the bulk chunk's shapes: the first 2 layers of
    ``cfg`` on 64 prompts of 512 tokens, max_len 1024, prefill + 4
    greedy decode steps through the kernels (K1 at b = 64, S = 512; K2 at
    b = 64 against 1024 rows, kv_len 512-516) against the kernels' plain
    versions fed the kernel run's greedy tokens (so that one flipped
    argmax does not feed the two runs different tokens), tolerance max
    |dlogit| <= 5e-2 max |logit|; and, as phase 6 holds zamba2, the
    kernel run no farther from an fp32 run of the plain versions on the
    same tokens than 1.5 times the plain bf16 run is."""
    cfg2, params2 = first_blocks(2)(cfg, params)
    gen = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, (BULK_REQUESTS, JOB_PROMPT),
                           generator=gen, dtype=torch.int32).to(dev)
    _zero_launches()
    got, toks = greedy_run(cfg2, params2, prompt, 1024)
    counts = _launches()
    if counts != {"flash_attention": 2, "flash_decode": 8, "ssd_scan": 0}:
        raise AssertionError(f"the b = 64 check's launches: {counts}")
    with no_tf32(), plain_kernels():
        plain, plain_toks = greedy_run(cfg2, params2, prompt, 1024, toks)
        ref, _ = greedy_run(cfg2.replace(dtype="float32"),
                            _map(lambda t: t.float(), params2), prompt,
                            1024, toks)
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite logits through the kernels")
    rel = rel_err(got, plain)
    by_step = [rel_err(got[i], plain[i]) for i in range(got.shape[0])]
    equal = (toks == plain_toks).float().mean().item()
    log(f"15a reference check at b = 64 ({cfg.arch_id} widths, 2 layers, "
        f"prompt {JOB_PROMPT}, max_len 1024, 4 decode steps, bf16): "
        f"kernels vs plain versions, max |dlogit| / max |logit| = "
        f"{rel:.3e} (tol 5e-2; by step "
        + ", ".join(f"{e:.3e}" for e in by_step)
        + f"), greedy tokens equal {equal:.3f}; from the fp32 run: kernels "
        f"{rel_err(got, ref):.3e}, plain versions {rel_err(plain, ref):.3e}")
    if rel > 5e-2:
        raise AssertionError(f"b = 64 logits off: max rel err {rel}")
    if not rel_err(got, ref) <= 1.5 * rel_err(plain, ref):
        raise AssertionError(f"b = 64 logits off: {rel_err(got, ref)} from "
                             f"fp32 against the plain bf16 run's "
                             f"{rel_err(plain, ref)}")


def phase_oracle_sweep(dev, watts):
    """15b: the paper's comparison on phase 5's configuration: reduced
    stablelm-1.6b, ``accel:chunk=8:async=2`` on cuda:0 and ``cpu0`` on
    the CPU, 64 requests of 128 prompt + 16 decode tokens.
    ``BulkScheduler.oracle(0, 64)`` (all eleven splits) between two
    dynamic ``serve(64)`` runs on the same groups; energy modelled with
    the accel group at the card's limit and cpu0 at 65 / 10 W."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import DeviceKind
    from repro_torch.serve.engine import GroupDef, HeteroServeEngine
    cfg = reduced(get_config("stablelm-1.6b"))
    groups = [GroupDef("accel", DeviceKind.ACCEL, device=dev, fixed_chunk=8,
                       async_depth=2),
              GroupDef("cpu0", DeviceKind.BIG, device=torch.device("cpu"))]
    energy = _energy_model(watts, ("cpu0",))
    eng = HeteroServeEngine(cfg, groups, prompt_len=128,
                            decode_tokens=JOB_DECODE, seed=0)
    dynamic = [_dynamic_out(eng, energy)[0]]
    bulk = _bulk_scheduler(eng)
    splits, run = [], bulk.run

    def recording_run(begin, end, frac):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = run(begin, end, frac)
        torch.cuda.synchronize()
        splits.append((res, _bulk_out(eng, res, energy)[0]))
        return res

    bulk.run = recording_run
    _zero_launches()
    best = bulk.oracle(0, BULK_REQUESTS)
    counts = _launches()
    dynamic.append(_dynamic_out(eng, energy)[0])
    fracs = [res.frac for res, _ in splits]
    if fracs != [k / 10 for k in range(11)]:
        raise AssertionError(f"the sweep ran fracs {fracs}")
    last = splits[-1][0].per_group_items
    if last != {"accel": BULK_REQUESTS}:
        raise AssertionError(f"the last split is {last}, not 64 / 0")
    accel_runs = sum(1 for res, _ in splits if res.per_group_items.get(
        "accel", 0))
    _expect_launches(counts, accel_runs, cfg.n_layers)
    (best_out,) = [out for res, out in splits if res is best]
    rows = [{"frac": out["frac"], "time_s": out["time_s"],
             "items": out["items"], "edp_js": out["edp_js"],
             "accel_overheads": out["accel_overheads"]}
            for _, out in splits]
    log(f"15b oracle sweep (reduced stablelm-1.6b, accel on cuda:0 + cpu0, "
        f"64 x 128 + 16, energy {MODELLED}, accel {watts} W, cpu0 "
        f"{CPU_POWER_W[0]} / {CPU_POWER_W[1]} W): " + json.dumps(rows))
    norm = [{"time": d["time_s"] / best_out["time_s"],
             "energy": d["energy_j"] / max(best_out["energy_j"], 1e-12),
             "edp": d["edp_js"] / max(best_out["edp_js"], 1e-12)}
            for d in dynamic]
    log(f"15b best split frac {best.frac} ({best_out['items']}): "
        f"{json.dumps(best_out)}")
    log(f"15b dynamic before / after the sweep: {json.dumps(dynamic)}")
    log(f"15b dynamic normalised to the best Bulk-Oracle run (time, "
        f"energy, EDP; < 1 means dynamic is better): {json.dumps(norm)}")
    return counts


def _load_example(name):
    import importlib.util
    path = ROOT / "examples" / "torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(dev):
    """15c: ``examples/torch`` serve_hetero, observe and train_hetero_lm
    (20 steps) in this process, group accel on cuda:0 and cpu0 on the
    CPU; their own assertions hold (train_hetero_lm: the loss falls), and
    the accel group launched the kernels. Their temporary files go to a
    directory removed afterwards."""
    import tempfile
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        tempfile.tempdir = tmp
        try:
            for name, argv in (("serve_hetero", []), ("observe", []),
                               ("train_hetero_lm", ["--steps", "20"])):
                t0 = time.perf_counter()
                _zero_launches()
                _load_example(name).main(argv + ["--device", "cuda"])
                counts[name] = _launches()
                log(f"15c example {name} on cuda:0: "
                    f"{time.perf_counter() - t0:.2f} s, launches "
                    f"{counts[name]}")
                if counts[name]["flash_attention"] < 1 or (
                        name != "train_hetero_lm"
                        and counts[name]["flash_decode"] < 1):
                    raise AssertionError(f"example {name} ran no kernel")
        finally:
            tempfile.tempdir = None
    return counts


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _described(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_described(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), v.dtype)
    return out


def phase_memory_plan(cfg, params):
    """15d: for every architecture in the registry at full width, the
    bytes of its abstract parameters (meta tensors: nothing allocated),
    its AdamW state and each applicable dry-run shape's inputs and caches;
    stablelm-1.6b's abstract parameters must have the leaf paths, shapes
    and dtypes of phase 4's materialised ones."""
    from repro_torch.configs.registry import dryrun_cells, list_archs, \
        get_config
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import abstract_opt_state
    plan = {}
    for arch in list_archs():
        c = get_config(arch)
        p = M.abstract_params(c)
        plan[arch] = {"params": _nbytes(p),
                      "adamw_state": _nbytes(abstract_opt_state(p))}
    for c, shape, _, _ in dryrun_cells():
        specs = M.input_specs(c, shape)
        plan[c.arch_id][shape.name] = {
            "inputs": _nbytes({k: v for k, v in specs.items()
                               if k != "cache"}),
            "cache": _nbytes(specs["cache"]) if "cache" in specs else 0}
    log("15d memory plan (bytes; full width, meta tensors): "
        + json.dumps(plan))
    got, want = _described(M.abstract_params(cfg)), _described(params)
    if got != want:
        raise AssertionError(
            f"{cfg.arch_id}: abstract parameters differ from the "
            f"materialised ones at "
            f"{sorted(set(got.items()) ^ set(want.items()))[:4]}")
    log(f"15d {cfg.arch_id}: {len(got)} abstract leaves equal phase 4's "
        f"materialised ones in path, shape and dtype")


def phase_paper_core(dev, cfg, params, smi):
    """Phase 15 (after phase 9, on phase 4's weights)."""
    t0 = time.perf_counter()
    watts = _power_limit_w(smi)
    counts = {f"{cfg.arch_id} bulk": phase_bulk_full_width(dev, cfg, params,
                                                           watts)}
    counts["reduced stablelm-1.6b oracle sweep"] = phase_oracle_sweep(
        dev, watts)
    for name, c in phase_examples(dev).items():
        counts[f"example {name}"] = c
    phase_memory_plan(cfg, params)
    log(f"phase 15: {time.perf_counter() - t0:.2f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 16: the sharding rules, the meshes and the multi-pod dry run (run in
# a child process, so that no process group meets the phases before it)
# ---------------------------------------------------------------------------

#: 16b: one dry-run cell per family, each on the 16 x 16 and 2 x 16 x 16
#: meshes (the training cells take minutes on the 3-D mesh: see PERF.md)
DRYRUN_CELLS = [("stablelm-1.6b", "prefill_32k"),
                ("granite-moe-1b-a400m", "decode_32k"),
                ("zamba2-1.2b", "long_500k"),
                ("xlstm-350m", "prefill_32k"),
                ("phi-3-vision-4.2b", "prefill_32k"),
                ("musicgen-large", "decode_32k")]


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def phase_mesh(dev):
    """16a: the card's power limit against ``CHIP_ACTIVE_W`` and its idle
    draw (the measurement behind ``CHIP_IDLE_W``); then a real process
    group of one rank on cuda:0 (a FileStore in a temporary directory):
    ``make_group_meshes([1])`` is a (1, 1) mesh, one of phase 4's weights
    is distributed on it by the rules' placements, and a DTensor product
    equals the plain one."""
    import os
    import statistics
    import tempfile
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import (CHIP_ACTIVE_W, CHIP_IDLE_W,
                                         make_group_meshes)
    from repro_torch.sharding import ShardingRules
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if _power_limit_w(smi) != CHIP_ACTIVE_W:
        raise AssertionError(f"power limit {smi} is not CHIP_ACTIVE_W "
                             f"{CHIP_ACTIVE_W} W")
    draws = []
    for _ in range(10):
        draws.append(float(subprocess.run(
            ["nvidia-smi", "--query-gpu=power.draw",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.split()[0]))
        time.sleep(0.2)
    log(f"16a card {smi}: power limit equals CHIP_ACTIVE_W = "
        f"{CHIP_ACTIVE_W} W; idle draw (power.draw, 10 samples over 2 s, "
        f"nothing running): median {statistics.median(draws)} W, min "
        f"{min(draws)} W, max {max(draws)} W (CHIP_IDLE_W = {CHIP_IDLE_W})")
    cfg, params = full_width_model(dev, "stablelm-1.6b")
    w = params["blocks"]["mlp"]["wi"][0]                  # (embed, mlp)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            (mesh,) = make_group_meshes([1], device_type="cuda")
            if tuple(mesh.shape) != (1, 1) or tuple(
                    mesh.mesh_dim_names) != ("data", "model"):
                raise AssertionError(f"group mesh {mesh}")
            rules = ShardingRules()
            gen = torch.Generator(device=dev).manual_seed(16)
            x = torch.randn(8, 512, cfg.d_model, generator=gen,
                            device=dev).to(w.dtype)
            wd = distribute_tensor(w, mesh, rules.placements(
                mesh, ("embed", "mlp"), w.shape))
            xd = distribute_tensor(x, mesh, rules.placements(
                mesh, ("act_batch", "act_seq", "act_embed"), x.shape))
            got = (xd @ wd).full_tensor()
            want = x @ w
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"DTensor product differs from the plain one by "
                    f"{(got.float() - want.float()).abs().max().item()}")
            log(f"16a make_group_meshes([1]) on cuda:0: {mesh}; "
                f"blocks/mlp/wi[0] {tuple(w.shape)} placed "
                f"{tuple(wd.placements)}, x {tuple(x.shape)} placed "
                f"{tuple(xd.placements)}: the DTensor product equals the "
                f"plain one bit for bit")
        finally:
            dist.destroy_process_group()
    del params, w, wd, x, xd
    free_model()


def phase_dryrun_cells():
    """16b: the dry-run CLI on one cell per family, single and multi, at
    full width; every cell ok."""
    from repro_torch.launch import dryrun
    for arch, shape in DRYRUN_CELLS:
        argv = ["--arch", arch, "--shape", shape, "--mesh", "both",
                "--no-hlo"]
        if dryrun.main(argv) != 0:
            raise AssertionError(f"dry run {arch} {shape} failed")
        for mesh_kind in ("single", "multi"):
            res = json.loads(dryrun.cell_path(arch, shape, mesh_kind)
                              .read_text())
            if res["status"] != "ok":
                raise AssertionError(f"dry run {mesh_kind} {arch} {shape}: "
                                     f"{res.get('error')}")
            log(f"16b dry run {mesh_kind} {arch} {shape}: memory "
                f"{json.dumps(res['memory'])} flops_per_device "
                f"{res['flops_per_device']:.6e} collectives "
                f"{json.dumps(res['collective_op_counts'])} trace_s "
                f"{res['trace_s']} total_s {res['total_s']}")


def phase_dryrun_vs_trainer(dev, measured_peak):
    """16c: the dry run of 13d's training chunk (stablelm-1.6b, 8 x 512,
    remat, AdamW) on a (1, 1) fake mesh predicts the argument bytes that
    13d's trainer holds on the card: its parameters, AdamW state (master,
    m, v and the step) and a chunk's tokens and labels; they must be
    equal. Its argument plus temp bytes are printed beside 13d's measured
    peak, a prediction, not a gate."""
    from repro_torch.configs.base import ShapeSuite
    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import DeviceKind
    from repro_torch.launch import dryrun
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import GroupDef, HeteroTrainer
    shape = ShapeSuite("train_chunk_8x512", TRAIN_SEQ, 8, "train")
    res = dryrun.run_cell("stablelm-1.6b", shape.name, "unit",
                          save_hlo=False, shape=shape)
    if res["status"] != "ok":
        raise AssertionError(f"16c dry run: {res.get('traceback')}")
    cfg = get_config("stablelm-1.6b")
    tr = HeteroTrainer(cfg, [GroupDef("accel", DeviceKind.ACCEL, device=dev,
                                      fixed_chunk=8, async_depth=2)],
                       seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                       oc=OptConfig(**TRAIN_OC), seed=0, repeat_data=True)
    chunk = tr.data.batch(0, 8)
    held = {"params": _tree_bytes(tr.params), "adamw": _tree_bytes(tr.opt),
            "tokens_labels": int(chunk["tokens"].nbytes
                                 + chunk["labels"].nbytes)}
    mem = res["memory"]
    log(f"16c dry run of 13d's chunk on a (1, 1) fake mesh: "
        f"{json.dumps(mem)}, flops {res['flops_per_device']:.6e}, trace_s "
        f"{res['trace_s']}; the trainer holds {json.dumps(held)} = "
        f"{sum(held.values())} bytes (and a loss mask of "
        f"{chunk['loss_mask'].nbytes} bytes the dry run's batch has not); "
        f"predicted peak argument + temp = "
        f"{mem['argument_bytes'] + mem['temp_bytes']} bytes beside 13d's "
        f"measured max_memory_allocated {measured_peak} bytes "
        f"(a prediction, not a gate)")
    if mem["argument_bytes"] != sum(held.values()):
        raise AssertionError(f"16c: the dry run's argument bytes "
                             f"{mem['argument_bytes']} != the trainer's "
                             f"{sum(held.values())}")
    del tr
    free_model()


def phase_dry_run_child(measured_peak: int):
    """Phase 16, in the child process; a failure's traceback goes to
    standard output, which the parent echoes."""
    import traceback
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    try:
        phase_mesh(dev)
        phase_dryrun_cells()
        phase_dryrun_vs_trainer(dev, measured_peak)
    except Exception:
        log(traceback.format_exc())
        raise SystemExit(1)
    log(f"phase 16: {time.perf_counter() - t0:.2f} s")


def phase_dry_run(measured_peak: int):
    """Phase 16 in a child process: its output echoed, any failure
    raised."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--phase16",
         str(measured_peak)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    for line in proc.stdout.splitlines():
        log(line)
    if proc.returncode:
        raise AssertionError(f"phase 16 failed (exit {proc.returncode}); "
                             f"its traceback is above")


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
    counts.update(phase_paper_core(dev, cfg, params, smi))
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
    # phase 11: the MoE family
    del params
    free_model()
    cfg, params = full_width_model(dev, "granite-moe-1b-a400m")
    phase_reference_moe(dev, cfg, params)
    phi_cfg, phi_params = first_layers(dev, "phi3.5-moe-42b-a6.6b", 2)
    phase_reference_moe(dev, phi_cfg, phi_params)
    del phi_params
    free_model()
    counts[cfg.arch_id], out = phase_main(
        dev, cfg, params, {"flash_attention": cfg.n_layers},
        {"flash_decode": cfg.n_layers})
    one_chunk_times(dev, cfg, params, out["max_len"])
    # phase 12: the xLSTM family, on no kernel
    del params
    free_model()
    cfg, params = full_width_model(dev, "xlstm-350m")
    phase_reference_xlstm(dev, cfg, params)
    counts[cfg.arch_id], out = phase_main(dev, cfg, params, {}, {})
    one_chunk_times(dev, cfg, params, out["max_len"])
    # phase 13: training
    del params
    free_model()
    rows["flash_attention"]["lse_shapes"] = phase_lse(dev)
    rows["flash_attention"]["training_backward"] = \
        phase_attention_backward(dev)
    cfg, params = full_width_model(dev, "stablelm-1.6b")
    phase_train_reference(dev, cfg, params, first_blocks(2),
                          {"flash_attention": 4, "flash_decode": 0,
                           "ssd_scan": 0})
    counts["stablelm-1.6b training"], train_out = phase_train_main(
        dev, cfg, params, {"flash_attention": 2 * cfg.n_layers})
    phase_train_ordering(dev, cfg, params)
    del params
    free_model()
    phase_train_hetero(dev)
    # phase 14: training the MoE, hybrid and xLSTM families
    rows["ssd_scan"]["training_backward"] = phase_ssd_backward(dev)
    cfg, params = full_width_model(dev, "granite-moe-1b-a400m")
    phase_train_reference(dev, cfg, params, first_blocks(2),
                          {"flash_attention": 4, "flash_decode": 0,
                           "ssd_scan": 0})
    counts[f"{cfg.arch_id} training"], _ = phase_train_main(
        dev, cfg, params, {"flash_attention": 2 * cfg.n_layers})
    phase_recompute_routing(dev, cfg, params)
    del params
    free_model()
    from repro_torch.models.hybrid import hybrid_layout
    cfg, params = full_width_model(dev, "zamba2-1.2b")
    phase_train_reference(dev, cfg, params,
                          lambda c, p: hybrid_cut(c, p, 7),
                          {"flash_attention": 2, "flash_decode": 0,
                           "ssd_scan": 2 * 6 + 1})
    # remat per group: a group's Mamba-2 blocks and shared block run twice
    # a chunk (forward, recompute), the tail blocks once, as in the JAX
    # package (src/repro/models/hybrid.py:63-67)
    n_groups, k, tail = hybrid_layout(cfg)
    counts[f"{cfg.arch_id} training"], _ = phase_train_main(
        dev, cfg, params, {"ssd_scan": 2 * n_groups * k + tail,
                           "flash_attention": 2 * n_groups})
    del params
    free_model()
    cfg, params = full_width_model(dev, "xlstm-350m")
    phase_train_reference(dev, cfg, params, first_pair,
                          {"flash_attention": 0, "flash_decode": 0,
                           "ssd_scan": 0})
    counts[f"{cfg.arch_id} training"], _ = phase_train_main(
        dev, cfg, params, {}, steps=XLSTM_TRAIN_STEPS,
        seq_len=XLSTM_TRAIN_SEQ, global_batch=XLSTM_TRAIN_BATCH)
    del params
    free_model()
    phase_dry_run(train_out["max_memory_allocated"])
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
            "shapes": r.get("shapes", {}),
            **{k: r[k] for k in ("lse_shapes", "training_backward")
               if k in r}})
    assert all(math.isfinite(k["ms"]) and k["launches"] > 0
               for k in kernels)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase16"]:
        phase_dry_run_child(int(sys.argv[2]))
    else:
        main()
