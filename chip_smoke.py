#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each uncaught (any failure exits non-zero and prints no result):

1. the card (name and power limit from nvidia-smi), torch and CUDA
   versions, and the build of every CUDA kernel from ``csrc/`` (one nvcc per
   source, all started together);
2. each kernel against its plain PyTorch version on the card, in bf16 at
   the serving path's shapes: max abs error and tolerance, time per call
   from CUDA events, the bound (the larger of bytes over 3.35 TB/s and
   FLOPs over 989 TFLOP/s), the plain version's time and, as a yardstick
   the port never calls, ``F.scaled_dot_product_attention``'s time;
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
   ``cpu0`` on the CPU, on reduced stablelm-1.6b.

Then a JSON line with every kernel's numbers, the nvidia-smi line, and as
the last line ``{"ok": true, "device": {...}}``. It needs one card, runs
nothing on the CPU in its place, and fails without ``src/repro_torch``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak
TOL = 2e-2                         # tests/test_kernels.py's bf16 tolerance


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
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return smi


def phase_kernels(dev):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD

    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev) \
            .to(torch.bfloat16)

    rows = {}
    # K1: prefill shapes (b=8, 32 heads, D=64), causal
    fa_err = 0.0
    for name, sq, h, kvh in [("main", 512, 32, 32), ("ragged", 1000, 32, 32),
                             ("gqa", 512, 32, 8)]:
        b, d = 8, 64
        q, k, v = rnd(b, sq, h, d), rnd(b, sq, kvh, d), rnd(b, sq, kvh, d)
        out = FA.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        exp = FA.flash_attention_plain(q, k, v, causal=True)
        err = (out.float() - exp.float()).abs().max().item()
        if not torch.allclose(out.float(), exp.float(), rtol=TOL, atol=TOL):
            raise AssertionError(f"flash_attention {name}: max abs err {err}")
        fa_err = max(fa_err, err)
        ms = cuda_ms(lambda: FA.flash_attention(q, k, v, causal=True), 50)
        plain_ms = cuda_ms(
            lambda: FA.flash_attention_plain(q, k, v, causal=True), 5)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=h != kvh), 50)
        nbytes = 2 * (2 * b * sq * h * d + 2 * b * sq * kvh * d)
        flops = 4 * b * h * d * (sq * (sq + 1) // 2)
        b_ms, b_by = bound(nbytes, flops)
        log(f"flash_attention {name}: b={b} S={sq} H={h} KVH={kvh} D={d} "
            f"max_abs_err={err:.3e} (tol {TOL}) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by})")
        if name == "main":
            rows["flash_attention"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)
    rows["flash_attention"]["max_abs_err"] = fa_err

    # K2: decode against a 1024-row cache (b=8, 32 heads, D=64)
    fd_err = 0.0
    for name, kvh, lens in [("main", 32, "520"), ("ragged", 32, "random"),
                            ("gqa", 8, "random")]:
        b, S, h, d = 8, 1024, 32, 64
        q, kc, vc = rnd(b, 1, h, d), rnd(b, S, kvh, d), rnd(b, S, kvh, d)
        if lens == "520":
            kv_len = torch.full((b,), 520, dtype=torch.int32, device=dev)
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
        ms = cuda_ms(lambda: FD.flash_decode(q, kc, vc, kv_len), 200)
        plain_ms = cuda_ms(lambda: FD.flash_decode_plain(q, kc, vc, kv_len),
                           10)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kc, vc))
        mask = (torch.arange(S, device=dev)[None, :]
                < kv_len[:, None])[:, None, None, :]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=h != kvh), 200)
        rows_read = int(kv_len.sum().item())
        nbytes = 2 * (2 * b * h * d + 2 * rows_read * kvh * d) + 4 * b
        flops = 4 * rows_read * h * d
        b_ms, b_by = bound(nbytes, flops)
        log(f"flash_decode {name}: b={b} S={S} H={h} KVH={kvh} D={d} "
            f"kv_len sum={rows_read} max_abs_err={err:.3e} (tol {TOL}) "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by})")
        if name == "main":
            rows["flash_decode"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)
    rows["flash_decode"]["max_abs_err"] = fd_err
    return rows


class plain_attention:
    """Within the block, the model's attention calls the kernels' plain
    versions instead of the kernels (the reference run of phase 3)."""

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.kernels.flash_attention import flash_attention_plain
        from repro_torch.kernels.flash_decode import flash_decode_plain
        self.ops = ops
        self.saved = ops.attention_bshd, ops.decode_attention_bshd
        ops.attention_bshd = lambda q, k, v, n_heads, n_kv_heads, causal, \
            q_offset: flash_attention_plain(q, k, v, causal=causal,
                                            q_offset=q_offset)
        ops.decode_attention_bshd = lambda q, kc, vc, kv_len, n_heads, \
            n_kv_heads: flash_decode_plain(q, kc, vc, kv_len)
        return self

    def __exit__(self, *exc):
        self.ops.attention_bshd, self.ops.decode_attention_bshd = self.saved


def phase_reference(dev, cfg, params):
    """The model at full width on a small input, cut to 2 layers (the
    first 2 of the main path's weights): prefill + 4 greedy decode steps
    through the kernels, against the same run with the kernels' plain
    versions in their place, both in bf16 on the card. The two differ by
    bf16 rounding inside attention, which the random weights' very sharp
    softmax amplifies from layer to layer: tolerance max |dlogit| <=
    5e-2 * max |logit|."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.models import model as M
    cfg2 = cfg.replace(n_layers=2)
    params2 = dict(params, blocks=_map(lambda t: t[:2], params["blocks"]))
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                           dtype=torch.int32).to(dev)

    def run():
        out = []
        with torch.no_grad():
            logits, cache = M.prefill(cfg2, params2, tokens, max_len=128)
            out.append(logits.float())
            for _ in range(4):
                tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                logits, cache = M.decode_step(cfg2, params2, cache, tok)
                out.append(logits.float())
        return torch.stack(out)

    fa0, fd0 = FA.launches, FD.launches
    got = run()
    if (FA.launches - fa0, FD.launches - fd0) != (2, 8):
        raise AssertionError("the reference check did not run the kernels")
    with plain_attention():
        ref = run()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite logits through the kernels")
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    same = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"reference check (stablelm-1.6b widths, 2 layers, b=2, prompt 64, "
        f"4 decode steps, bf16): kernels vs plain versions, max |dlogit| / "
        f"max |logit| = {rel:.3e} (tol 5e-2), greedy tokens equal "
        f"{same:.3f}")
    if rel > 5e-2:
        raise AssertionError(f"full-width logits off: max rel err {rel}")


def _serve(cfg, groups, requests, prompt_len, decode_tokens, params=None):
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.serve.engine import HeteroServeEngine
    eng = HeteroServeEngine(cfg, groups, prompt_len=prompt_len,
                            decode_tokens=decode_tokens, seed=0,
                            params=params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.launches = FD.launches = 0
    rep = eng.serve(requests)
    counts = {"flash_attention": FA.launches, "flash_decode": FD.launches}
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


def full_width_model(dev):
    """stablelm-1.6b at full width (24 layers, bf16), random weights from a
    torch.Generator seeded with 0."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    cfg = get_config("stablelm-1.6b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"stablelm-1.6b: {n_params} parameters in {cfg.dtype}, init "
        f"{time.perf_counter() - t0:.2f} s")
    return cfg, params


def phase_main(dev, cfg, params):
    from repro_torch.core.types import DeviceKind
    from repro_torch.serve.engine import GroupDef
    requests, prompt_len, decode_tokens = 64, 512, 16
    groups = [GroupDef("accel", DeviceKind.ACCEL, device=dev, fixed_chunk=8,
                       async_depth=2)]
    eng, rep, counts = _serve(cfg, groups, requests, prompt_len,
                              decode_tokens, params=params)
    chunks = rep.overheads["accel"]["n_chunks"]
    want = {"flash_attention": cfg.n_layers * chunks,
            "flash_decode": cfg.n_layers * (decode_tokens - 1) * chunks}
    out = _report(rep, "accel")
    out.update(max_len=eng.max_len, chunks=chunks, launches=counts)
    log("main path report: " + json.dumps(out))
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


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main():
    smi = phase_card()
    dev = torch.device("cuda", 0)
    rows = phase_kernels(dev)
    cfg, params = full_width_model(dev)
    phase_reference(dev, cfg, params)
    counts, main_out = phase_main(dev, cfg, params)
    phase_hetero(dev, main_out)
    sources = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:73"),
        "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:62"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    assert all(math.isfinite(k["ms"]) for k in kernels)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
