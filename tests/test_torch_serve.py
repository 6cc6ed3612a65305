"""The port's serving path on the CPU: the engine against the JAX engine,
the twin of the JAX engine's integration test, the TorchChunkExecutor
contract, and the launcher's device rules.

Weights come from the JAX package through ``repro_torch.bridge``; the
config is reduced stablelm-1.6b in fp32 with 2 layers
(tests/test_integration.py's ``tiny_cfg``), and for the hybrid path
reduced zamba2-1.2b in fp32.
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
    _serve_tokens_match_the_jax_engine(*tiny_cfgs)


def test_serve_tokens_match_the_jax_engine_on_zamba2():
    """The same on reduced zamba2 in fp32 (4 layers: 2 groups of 2
    Mamba-2 blocks and the shared attention block), prompts of 16 tokens
    (one whole SSD chunk)."""
    _serve_tokens_match_the_jax_engine(
        jax_reduced("zamba2-1.2b").replace(dtype="float32"),
        get_reduced_config("zamba2-1.2b").replace(dtype="float32"))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "xlstm-350m"])
def test_serve_tokens_match_the_jax_engine_on_moe_and_xlstm(arch):
    """The same on reduced granite-moe (2 layers, 4 experts, top-2: a
    chunk of 4 prompts of 16 tokens is 64 tokens for a capacity of 40) and
    reduced xlstm-350m (2 pairs of an mLSTM and an sLSTM block; prompts of
    one whole mLSTM chunk), in fp32. Nothing here is family-specific: the
    engine serves both unchanged."""
    _serve_tokens_match_the_jax_engine(
        jax_reduced(arch).replace(dtype="float32"),
        get_reduced_config(arch).replace(dtype="float32"))


def _serve_tokens_match_the_jax_engine(cfg_j, cfg_t):
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


def test_launcher_refuses_float32_on_the_card(capsys):
    """fp32 on CUDA is refused before any engine is built, and before the
    check for a card, so this machine reaches it with or without one;
    ``--device cpu`` serves fp32."""
    with pytest.raises(SystemExit) as exc:
        serve_cli.main(["--arch", "stablelm-1.6b", "--reduced", "--dtype",
                        "float32"])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "bfloat16" in err and "--device cpu" in err
    serve_cli.main(["--arch", "stablelm-1.6b", "--reduced", "--device",
                    "cpu", "--requests", "2", "--prompt-len", "8",
                    "--decode-tokens", "2", "--dtype", "float32",
                    "--groups", "accel:chunk=2"])
    assert json.loads(capsys.readouterr().out)["new_tokens"] == 4


def test_engine_refuses_float32_on_a_cuda_group(tiny_cfgs):
    """A CUDA group with an fp32 config is refused when the engine is
    built, before any weight is drawn or placed (so no card is needed
    to see it); the same config serves on a CPU group."""
    _, cfg = tiny_cfgs
    groups = [GroupDef("accel", DeviceKind.ACCEL, device="cuda:0"),
              GroupDef("cpu0", DeviceKind.BIG, device=CPU)]
    with pytest.raises(ValueError, match="bfloat16"):
        HeteroServeEngine(cfg, groups)
    HeteroServeEngine(cfg, groups[1:])


def test_launcher_serves_on_the_cpu_when_asked(capsys):
    serve_cli.main(["--arch", "stablelm-1.6b", "--reduced", "--device",
                    "cpu", "--requests", "6", "--prompt-len", "8",
                    "--decode-tokens", "3", "--dtype", "float32",
                    "--groups", "accel:chunk=2:async=2,cpu0"])
    out = json.loads(capsys.readouterr().out)
    assert out["requests"] == 6 and out["new_tokens"] == 18
    assert sum(out["per_group"].values()) == 6
    assert "O_td" in out["accel_overheads"]


def test_launcher_serves_zamba2_on_the_cpu(capsys):
    serve_cli.main(["--arch", "zamba2-1.2b", "--reduced", "--device", "cpu",
                    "--requests", "4", "--prompt-len", "13",
                    "--decode-tokens", "3", "--dtype", "float32",
                    "--groups", "accel:chunk=2:async=2,cpu0"])
    out = json.loads(capsys.readouterr().out)
    assert out["requests"] == 4 and out["new_tokens"] == 12
    assert sum(out["per_group"].values()) == 4


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "xlstm-350m"])
def test_launcher_serves_moe_and_xlstm_on_the_cpu(arch, capsys):
    serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--requests", "4", "--prompt-len", "13",
                    "--decode-tokens", "3", "--dtype", "float32",
                    "--groups", "accel:chunk=2:async=2,cpu0"])
    out = json.loads(capsys.readouterr().out)
    assert out["requests"] == 4 and out["new_tokens"] == 12
    assert sum(out["per_group"].values()) == 4


# ---------------------------------------------------------------------------
# telemetry snapshots (ROADMAP C7)
# ---------------------------------------------------------------------------

def test_telemetry_snapshot_has_the_jax_engines_keys(tiny_cfgs):
    """Both engines serve the same 8 requests on reduced stablelm with
    telemetry on: the snapshots carry the same sections and, in each, the
    same metric names (the values are timings and differ). Both return
    None when uninstrumented."""
    from repro import telemetry as jtel
    from repro_torch import telemetry as ttel
    cfg_j, cfg_t = tiny_cfgs
    kw = dict(prompt_len=16, decode_tokens=4)
    jeng = JaxServeEngine(
        cfg_j, [JaxGroupDef("accel", JaxDeviceKind.ACCEL, fixed_chunk=4)],
        telemetry=jtel.Telemetry(sample_rate=1.0), **kw)
    teng = HeteroServeEngine(
        cfg_t, [GroupDef("accel", DeviceKind.ACCEL, device=CPU,
                         fixed_chunk=4)],
        telemetry=ttel.Telemetry(sample_rate=1.0),
        params=params_from_jax(cfg_t, jax.tree.map(np.asarray, jeng.params),
                               CPU), **kw)
    jeng.serve(8)
    teng.serve(8)
    snap_j, snap_t = jeng.telemetry_snapshot(), teng.telemetry_snapshot()
    assert snap_t.keys() == snap_j.keys()
    for section, entries in snap_j.items():
        if isinstance(entries, dict):
            assert snap_t[section].keys() == entries.keys(), section
    chunks = 'sched.chunks{group="accel"}'
    assert snap_t["counters"][chunks] == snap_j["counters"][chunks] == 2
    off_j = JaxServeEngine(
        cfg_j, [JaxGroupDef("accel", JaxDeviceKind.ACCEL, fixed_chunk=4)],
        telemetry=jtel.OFF, **kw)
    off_t = HeteroServeEngine(
        cfg_t, [GroupDef("accel", DeviceKind.ACCEL, device=CPU,
                         fixed_chunk=4)], telemetry=ttel.OFF, **kw)
    assert off_j.telemetry_snapshot() is None
    assert off_t.telemetry_snapshot() is None
