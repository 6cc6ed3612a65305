"""One run of one benchmark cell of the PyTorch and CUDA port on NVIDIA
GPUs:

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout. ``BENCHMARK.json`` names the cells; the
harness is ``gpubench/bench.py``. With ``--trace 0`` the last line of
standard output is the result with the cell's end-to-end metrics, with
``--trace 1`` with its per-layer metrics (and a traced call). The numbers
that decide ``correct`` are printed last on standard error, each beside
its limit, and under ``checks`` at the end of the result line.

The run exits non-zero and prints no result when no CUDA card is there,
when fewer cards are there than the cell asks for, when JAX or the JAX
package is loaded, or when anything fails.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    # one process with few threads: the host's cores are shared
    torch.set_num_threads(2)
    from gpubench import bench
    from gpubench.power import PowerSampler
    chips = bench.Benchmark(ROOT).cell(args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"gpubench: the cell needs {chips} CUDA card(s); {found} "
              f"found", file=sys.stderr)
        return 2
    # the card as nvidia-smi names it: the first visible one's index or
    # UUID
    gpu = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0] or "0"
    line = bench.run(ROOT, args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda:0", T_START, PowerSampler(gpu))
    loaded = bench.forbidden_modules()
    if loaded:
        print(f"gpubench: JAX or the JAX package was loaded: {loaded}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"check correct {line['correct']} attempted {line['attempted']} "
          f"failed {line['failed']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
