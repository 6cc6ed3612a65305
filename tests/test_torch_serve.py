"""The port's serving path on the CPU: the engine against the JAX engine,
the twin of the JAX engine's integration test, the TorchChunkExecutor
contract, and the launcher's device rules.

Weights come from the JAX package through ``repro_torch.bridge``; the
config is reduced stablelm-1.6b in fp32 with 2 layers
(tests/test_integration.py's ``tiny_cfg``).
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced_config as jax_reduced
from repro.core.types import DeviceKind as JaxDeviceKind
from repro.serve.engine import HeteroServeEngine as JaxServeEngine
from repro.train.trainer import GroupDef as JaxGroupDef
from repro_torch.bridge import params_from_jax
from repro_torch.configs.registry import get_reduced_config
from repro_torch.core import (Chunk, ChunkFailure, ChunkRecord, DeviceKind,
                              Token, TorchChunkExecutor)
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as TM
from repro_torch.serve.engine import GroupDef, HeteroServeEngine

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def tiny_cfgs():
    return (jax_reduced("stablelm-1.6b").replace(n_layers=2, dtype="float32"),
            get_reduced_config("stablelm-1.6b").replace(n_layers=2,
                                                        dtype="float32"))


# ---------------------------------------------------------------------------
# engine parity with the JAX engine
# ---------------------------------------------------------------------------

def test_serve_tokens_match_the_jax_engine(tiny_cfgs):
    """One fixed-chunk group on each side, so both cut the same batches.
    Greedy tokens are compared exactly; the test first checks, along the
    port's greedy path, that no top-two logits lie within 1e-4 of each
    other, where fp32 summation order could flip an argmax."""
    cfg_j, cfg_t = tiny_cfgs
    n, prompt_len, decode_tokens = 8, 16, 4
    jeng = JaxServeEngine(
        cfg_j, [JaxGroupDef("accel", JaxDeviceKind.ACCEL, fixed_chunk=4)],
        prompt_len=prompt_len, decode_tokens=decode_tokens)
    jres = jeng._build_scheduler(max_chunk=n).run(0, n)
    jax_tokens = {}
    for rec in jres.records:
        c = rec.token.chunk
        for i in range(c.size):
            jax_tokens[c.begin + i] = rec.meta["result"]["tokens_out"][i]

    params = params_from_jax(cfg_t, jax.tree.map(np.asarray, jeng.params),
                             CPU)
    teng = HeteroServeEngine(
        cfg_t, [GroupDef("accel", DeviceKind.ACCEL, device=CPU,
                         fixed_chunk=4)],
        prompt_len=prompt_len, decode_tokens=decode_tokens, params=params)
    rep = teng.serve(n)
    assert rep.requests == n and sorted(rep.tokens_out) == list(range(n))

    prompts = torch.from_numpy(np.stack([teng._prompt(i) for i in range(n)]))
    margins = []
    with torch.no_grad():
        logits, cache = TM.prefill(cfg_t, params, prompts,
                                   max_len=teng.max_len)
        for step in range(decode_tokens):
            top2 = logits[:, -1].topk(2, dim=-1).values
            margins.append((top2[:, 0] - top2[:, 1]).min().item())
            if step + 1 < decode_tokens:
                tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                logits, cache = TM.decode_step(cfg_t, params, cache, tok)
    assert min(margins) > 1e-4, margins
    for i in range(n):
        np.testing.assert_array_equal(rep.tokens_out[i], jax_tokens[i])


def test_serve_engine_completes_all_requests(tiny_cfgs):
    """Twin of tests/test_integration.py::test_serve_engine_completes_all_
    requests, with both groups on the CPU."""
    _, cfg = tiny_cfgs
    groups = [
        GroupDef("accel", DeviceKind.ACCEL, device=CPU, fixed_chunk=4,
                 async_depth=2),
        GroupDef("cpu0", DeviceKind.BIG, device=CPU, slowdown=2.0),
    ]
    eng = HeteroServeEngine(cfg, groups, prompt_len=16, decode_tokens=4)
    rep = eng.serve(12)
    assert rep.requests == 12
    assert rep.new_tokens == 48
    assert set(rep.per_group_items) <= {"accel", "cpu0"}
    assert sum(rep.per_group_items.values()) == 12
    assert sorted(rep.tokens_out) == list(range(12))
    assert all(t.shape == (4,) for t in rep.tokens_out.values())


def test_serve_survives_a_group_death(tiny_cfgs):
    """A group that dies after its first chunk hands its in-flight chunks
    back (TorchChunkExecutor.abort) and the survivor serves them. As in
    the JAX package, a requeued chunk runs again at fresh indices past the
    end of the space, so the count of served requests is conserved."""
    _, cfg = tiny_cfgs
    groups = [
        GroupDef("accel", DeviceKind.ACCEL, device=CPU, fixed_chunk=2,
                 async_depth=2, fail_after_chunks=1),
        GroupDef("cpu0", DeviceKind.BIG, device=CPU),
    ]
    eng = HeteroServeEngine(cfg, groups, prompt_len=8, decode_tokens=2)
    rep = eng.serve(10)
    assert rep.requests == 10 and len(rep.tokens_out) == 10
    assert rep.per_group_items.get("accel", 0) <= 2
    assert rep.per_group_items["cpu0"] >= 8


def test_engine_without_a_device_needs_a_card(tiny_cfgs):
    _, cfg = tiny_cfgs
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        HeteroServeEngine(cfg, [GroupDef("accel", DeviceKind.ACCEL)])


# ---------------------------------------------------------------------------
# TorchChunkExecutor contract (CPU: outputs are ready when the step returns)
# ---------------------------------------------------------------------------

def _rec(begin, size=2):
    return ChunkRecord(Token(Chunk(begin, begin + size, begin), "g",
                             DeviceKind.ACCEL))


def _executor(async_depth=1, fail_on=None, **kw):
    def make_inputs(token):
        c = token.chunk
        return {"x": np.arange(c.begin, c.end, dtype=np.int32)}

    def step(batch):
        if fail_on is not None and int(batch["x"][0]) == fail_on:
            raise ChunkFailure("injected")
        return batch["x"] * 2

    return TorchChunkExecutor(step, make_inputs,
                              lambda outs: {"out": outs.numpy().tolist()},
                              device=CPU, async_depth=async_depth, **kw)


def test_executor_stamps_and_results_in_order():
    ex = _executor()
    rec = _rec(4)
    done = ex.execute(rec.token, rec)
    assert done == [rec]
    assert rec.meta["result"] == {"out": [8, 10]}
    assert rec.tg1 <= rec.tg2 <= rec.tg3 <= rec.tg4 <= rec.tg5 <= rec.tc3
    assert not ex._polling()      # CPU: no event to probe -> block mode


def test_executor_pipelines_to_its_depth_and_drains():
    ex = _executor(async_depth=2)
    recs = [_rec(i * 2) for i in range(3)]
    assert ex.execute(recs[0].token, recs[0]) == []
    assert ex.execute(recs[1].token, recs[1]) == []
    assert ex.execute(recs[2].token, recs[2]) == [recs[0]]
    assert ex.drain() == [recs[1], recs[2]]
    assert ex.drain() == []
    assert recs[2].meta["result"] == {"out": [8, 10]}


def test_executor_failure_keeps_finished_records_and_hands_back_chunks():
    ex = _executor(async_depth=2, fail_on=4)
    recs = [_rec(i * 2) for i in range(3)]
    ex.execute(recs[0].token, recs[0])
    ex.execute(recs[1].token, recs[1])
    with pytest.raises(ChunkFailure):
        ex.execute(recs[2].token, recs[2])
    # recs[0] finished before the failing launch: it is not discarded
    assert ex.completed() == [recs[0]]
    assert ex.abort() == [recs[1].token.chunk]
    assert ex.drain() == []


def test_executor_cancel_drains_without_a_probe():
    ex = _executor(async_depth=3)
    recs = [_rec(i * 2) for i in range(2)]
    for r in recs:
        ex.execute(r.token, r)
    assert ex.cancel() == recs
    assert ex.abort() == []


def test_executor_arguments_are_checked():
    with pytest.raises(ValueError, match="explicit device"):
        TorchChunkExecutor(lambda b: b, lambda t: None)
    with pytest.raises(ValueError, match="completion_mode"):
        TorchChunkExecutor(lambda b: b, lambda t: None, device=CPU,
                           completion_mode="spin")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_refuses_to_run_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit) as exc:
        serve_cli.main(["--arch", "stablelm-1.6b", "--reduced"])
    assert exc.value.code != 0
    assert "no CUDA GPU" in capsys.readouterr().err


def test_launcher_serves_on_the_cpu_when_asked(capsys):
    serve_cli.main(["--arch", "stablelm-1.6b", "--reduced", "--device",
                    "cpu", "--requests", "6", "--prompt-len", "8",
                    "--decode-tokens", "3", "--dtype", "float32",
                    "--groups", "accel:chunk=2:async=2,cpu0"])
    out = json.loads(capsys.readouterr().out)
    assert out["requests"] == 6 and out["new_tokens"] == 18
    assert sum(out["per_group"].values()) == 6
    assert "O_td" in out["accel_overheads"]
