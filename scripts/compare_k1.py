#!/usr/bin/env python3
"""K1 (flash-attention forward) of this tree against other builds of it,
on one CUDA card, in one call.

    python3 scripts/compare_k1.py [--baseline PATH.cu] [--variants cp.async,...]

Builds, with the flags of ``kernels/_build.py``, the working tree's
``csrc/flash_attention.cu`` ("tree"), an optional baseline source (the
parent's, say: ``git show HEAD~1:src/repro_torch/kernels/csrc/
flash_attention.cu > build/parent.cu``), and variants of the tree made by
rewriting a line or two of it:

- ``cp.async``: D = 96 and 128 copy their tiles by cp.async, 2 stages;
- ``no-head-groups`` / ``head-groups``: blocks always launched every
  head's heaviest q tile first, then every head's next / always in groups
  of heads (the tree groups them when K and V fill more than half the
  L2);
- ``heads-N``: groups of N heads (the tree has 32);
- ``drop-qk``, ``drop-softmax``, ``drop-pv``, ``drop-copies``: the loop
  without S = Q K^T, without the mask and online softmax (P = S cast),
  without O += P V, or without the kv copies after the first (D >= 96),
  for the time of what is left; their outputs are wrong and not checked.

Each build runs in its own process, in the order baseline, tree, variants,
tree, baseline, so drift on the card shows as a difference between the two
runs of one build. A process checks K1 at every wgmma head dim (64, 96,
128) against the plain version on small ragged inputs (GQA, a q_offset,
causal and full, 40 query heads on 10), then times it in a replayed CUDA
graph (``chip_smoke.graph_ms``) at phase 2's D >= 64 shapes, causal;
the first process of each build also times SDPA and prints the bound. One
JSON line per (build, shape); ptxas's registers and spills per kernel.
Needs one CUDA card; exits non-zero without one or when a build fails.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"
OUT = ROOT / "src/repro_torch/kernels/build/compare_k1"
SHAPES = [("main", 8, 512, 32, 32, 64), ("d96", 8, 656, 32, 32, 96),
          ("gqa8_d128", 8, 512, 32, 4, 128), ("d128", 8, 512, 32, 32, 128),
          ("gqa4_d128", 8, 512, 40, 10, 128),
          ("long_d128", 2, 4096, 40, 10, 128)]
TMA = "  static constexpr bool TMA = D != 64;\n"
STAGES = "  static constexpr int STAGES = TMA ? 2 : 3;\n"
GROUPS = "constexpr int WG_HEADS = 32;"
CHOICE = "      if (4.0 * b * g * skv * D > 0.5 * l2_bytes()) heads = WG_HEADS;"


#: parts of the tree's loop dropped, for timing only (their results are
#: wrong): (text, replacement) pairs
DROPS = {
    "drop-qk": [("        wgmma_ss(s, gmma_desc(q_tile + (ks >> 2) * "
                 "WG_Q_PANEL + off, 16, 1024),\n                 "
                 "gmma_desc(kt + (ks >> 2) * WG_PANEL + off, 16, 1024), ks);",
                 "        s[ks] += 1.f;")],
    "drop-softmax": [("      softmax_tile(s, m_run, l_run, pa, corr, n0, "
                      "pos_lo, skv, causal,\n                   scale_log2);",
                      "      for (int kt = 0; kt < BLOCK_N / 16; ++kt)\n"
                      "        for (int i = 0; i < 4; ++i)\n"
                      "          pa[kt][i] = pack_bf16(s[8 * kt + 2 * i], "
                      "s[8 * kt + 2 * i + 1]);\n"
                      "      corr[0] = corr[1] = 1.f;")],
    "drop-pv": [("        wgmma_rs(acc, pa[kt2], gmma_desc(vt + kt2 * 16 * "
                 "128,", "        if (false) wgmma_rs(acc, pa[kt2], "
                 "gmma_desc(vt + kt2 * 16 * 128,")],
    "drop-copies": [("    if (ahead < ntiles) load_tile(ahead);",
                     "    if (!C::TMA && ahead < ntiles) load_tile(ahead);"),
                    ("      mbar_wait(smem_u32(&bars[stage]), (t / STAGES) "
                     "& 1);", "      if (t == 0) mbar_wait(smem_u32(&bars["
                              "stage]), 0);")],
}


def variant(src: str, name: str) -> str:
    """The tree's source rewritten into variant ``name``."""
    if name in DROPS:
        for old, new in DROPS[name]:
            if old not in src:
                raise SystemExit(f"compare_k1: the source no longer holds "
                                 f"{old!r}")
            src = src.replace(old, new)
        return src
    for line in (TMA, STAGES, GROUPS, CHOICE):
        if line not in src:
            raise SystemExit(f"compare_k1: the source no longer holds "
                             f"{line!r}")
    if name == "cp.async":
        return src.replace(TMA, "  static constexpr bool TMA = false;\n") \
            .replace(STAGES, "  static constexpr int STAGES = "
                             "D == 64 ? 3 : 2;\n")
    if name == "no-head-groups":
        return src.replace(CHOICE, "")
    if name == "head-groups":
        return src.replace(CHOICE, "      heads = WG_HEADS;")
    if name.startswith("heads-"):
        return src.replace(GROUPS, f"constexpr int WG_HEADS = "
                                   f"{int(name[6:])};")
    raise SystemExit(f"compare_k1: unknown variant {name}")


def build(sources):
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(OUT / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    from chip_smoke import _kernel_name
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"compare_k1: build {name} failed:\n{log}")
        entry = "?"
        for line in log.splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                entry = _kernel_name(found.group(1))
            elif "registers" in line or "spill" in line:
                print(json.dumps({"build": name, "kernel": entry,
                                  "ptxas": line.strip()}), flush=True)


def run(name: str, first: bool):
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import _build, cost
    from repro_torch.kernels import flash_attention as FA
    _build._libs["flash_attention"] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for d in () if name in DROPS else (64, 96, 128):
        for b, sq, h, kvh, off, causal in [(2, 200, 8, 2, 0, True),
                                           (1, 77, 8, 2, 45, True),
                                           (3, 130, 4, 1, 0, False),
                                           (2, 300, 40, 10, 37, True),
                                           (1, 333, 40, 10, 0, False)]:
            q = torch.randn(b, sq, h, d, generator=gen, device=dev).bfloat16()
            k, v = (torch.randn(b, sq + off, kvh, d, generator=gen,
                                device=dev).bfloat16() for _ in range(2))
            out = FA.flash_attention(q, k, v, causal=causal, q_offset=off)
            exp = FA.flash_attention_plain(q, k, v, causal=causal,
                                           q_offset=off)
            err = (out.float() - exp.float()).abs().max().item()
            if not torch.allclose(out.float(), exp.float(), rtol=cs.TOL,
                                  atol=cs.TOL):
                raise AssertionError(f"{name} D={d} {(b, sq, h, kvh, off)} "
                                     f"causal={causal}: max abs err {err}")
            worst = max(worst, err)
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, b, sq, h, kvh, d in SHAPES:
        q, k, v = (torch.randn(b, sq, n, d, generator=gen, device=dev)
                   .bfloat16() for n in (h, kvh, kvh))
        row = {"build": name, "shape": shape, "small_max_abs_err": worst,
               "ms": cs.graph_ms(lambda: FA.flash_attention(q, k, v), 50)}
        if first and name not in DROPS:
            exp = FA.flash_attention_plain(q, k, v)
            row["max_abs_err"] = (FA.flash_attention(q, k, v).float()
                                  - exp.float()).abs().max().item()
            del exp
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            row["sdpa_ms"] = cs.graph_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=h != kvh), 50)
            row["bound_ms"], row["bound_by"] = cs.bound(
                cost.attention_bytes(b, sq, sq, h, kvh, d),
                cost.attention_flops(b, sq, sq, h, d))
        print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--variants", default="")
    ap.add_argument("--run", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_k1: no CUDA device")
    if args.run:
        return run(args.run[0], args.run[1] == "1")
    tree = SOURCE.read_text()
    sources = {"tree": tree}
    if args.baseline:
        sources["baseline"] = args.baseline.read_text()
    for name in filter(None, args.variants.split(",")):
        sources[name] = variant(tree, name)
    build(sources)
    ends = ["baseline"] if args.baseline else []
    variants = [n for n in sources if n not in ("tree", "baseline")]
    order = ends + ["tree"] + variants + ["tree"] + ends
    seen = set()
    for name in order:
        subprocess.run([sys.executable, __file__, "--run", name,
                        "0" if name in seen else "1"], check=True,
                       timeout=600)
        seen.add(name)


if __name__ == "__main__":
    main()
