"""The harness finds everything by name: a configuration, a traffic mix
and a metric added as new files (and new entries in BENCHMARK.json) make
a new cell with no edit of an existing file. And a run refuses, with no
result, where it cannot run."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import gpubench_tiny as tiny


def test_new_files_make_a_new_cell(tmp_path):
    root = tiny.make_root(tmp_path)
    g = root / "gpubench"
    before = {p: p.read_bytes() for p in g.rglob("*") if p.is_file()}
    (g / "configs" / "tiny-wide.json").write_text(json.dumps(
        tiny.tiny_config("stablelm-1.6b", "tiny-wide", d_ff=192)))
    (g / "traffic" / "tiny-short.json").write_text(json.dumps(
        dict(tiny.SERVE, prompt_len=8, decode_tokens=3)))
    (g / "metrics" / "requests_per_call.py").write_text(
        "def read(ctx):\n"
        "    return sum(c.items for c in ctx.calls) / len(ctx.calls)\n")
    (g / "limits" / "tiny-wide.short.json").write_text(
        (g / "limits" / "tiny-dense.serve.json").read_text())
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "tiny-wide.short",
                             "config": "tiny-wide", "traffic": "tiny-short",
                             "chips": 1, "why": "test"})
    doc["end_to_end"][0]["workloads"].append("tiny-wide.short")
    doc["per_layer"].append({"name": "requests_per_call", "unit": "requests",
                             "better": "higher", "source": "host_clock",
                             "layer": "engine", "moves": "tok_per_s",
                             "workloads": ["tiny-wide.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    line = tiny.run_cpu(root, "tiny-wide.short", trace=True)
    assert line["metrics"]["requests_per_call"]["value"] == 16
    assert line["correct"] and line["attempted"] % 16 == 0
    line = tiny.run_cpu(root, "tiny-wide.short")
    assert line["metrics"]["tok_per_s"]["value"] > 0
    assert all(p.read_bytes() == b for p, b in before.items())


def _run(root, cwd):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run(
        [sys.executable, str(root / "gpubench" / "run.py"), "--workload",
         "stablelm-1.6b.decode", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is there: the run would run")
    got = _run(tiny.ROOT, tiny.ROOT)
    assert got.returncode != 0 and got.stdout.strip() == ""
    assert "CUDA card" in got.stderr


def test_the_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _run(tmp_path, tmp_path)
    assert got.returncode != 0 and got.stdout.strip() == ""
