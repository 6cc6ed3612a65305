"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) and the
abstract evaluation under it.

* Each kernel wrapper on the meta device, under ``kernels.cost.recording``,
  returns the kernel's output shapes and dtypes (K1's row log-sum-exp L
  and K3's final state too), launches nothing, and charges the FLOPs of
  the bound formula ``chip_smoke.py`` used before the formulas moved into
  ``kernels.cost``.
* The meta scans (sLSTM per token, mLSTM per chunk) give the eager scans'
  output, final-state and gradient shapes on a reduced config, and the
  products they charge equal the ones the eager scans do.
* One full-width cell of each family, and yi-6b decode_32k on the 2 x 16 x
  16 mesh, trace with status ok; rank 0's argument bytes equal the bytes
  the reference's own PartitionSpecs give its ShapeDtypeStructs (the sum
  over leaves of the ceil-divided dims times the itemsize).
* ``main`` writes a cell's JSON and its communication dump.
"""
import json
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.registry import get_config as jax_config
from repro.configs.base import SHAPES_BY_NAME as JAX_SHAPES
from repro.models import model as JM
from repro.sharding.rules import ShardingRules as JaxRules
from repro.train import optimizer as JO
from repro_torch.configs.registry import get_reduced_config
from repro_torch.kernels import cost
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.launch import dryrun
from repro_torch.models import ssm
from repro_torch.models.layers import init_from_defs

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
    assert not dist.is_initialized()


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# the kernels' meta branches
# ---------------------------------------------------------------------------

def _old_ssd_flops(b, s, nh, P, N, Q):
    """chip_smoke.py's ``ssd_flops`` as it stood before it moved."""
    flops = 0
    for c0 in range(0, s, Q):
        L = min(Q, s - c0)
        flops += b * nh * (L * (L + 1) // 2 * 2 * (N + P) + 4 * L * N * P)
    return flops


@pytest.mark.parametrize("lse", [False, True])
def test_flash_attention_meta_branch(lse):
    b, sq, h, kvh, d = 2, 300, 8, 2, 64
    before = FA.launches
    with cost.recording() as got:
        out = FA.flash_attention(_meta(b, sq, h, d), _meta(b, sq, kvh, d),
                                 _meta(b, sq, kvh, d), causal=True,
                                 return_lse=lse)
    o, L = out if lse else (out, None)
    assert o.shape == (b, sq, h, d) and o.dtype == torch.bfloat16
    assert o.is_meta
    if lse:
        assert L.shape == (b, h, sq) and L.dtype == torch.float32
    assert FA.launches == before
    assert got["flash_attention"]["flops"] == 4 * b * h * d * (
        sq * (sq + 1) // 2)
    assert got["flash_attention"]["bytes"] == 2 * (
        2 * b * sq * h * d + 2 * b * sq * kvh * d) + (4 * b * h * sq if lse
                                                      else 0)
    assert got["flash_attention"]["calls"] == 1


def test_flash_decode_meta_branch():
    b, S, h, kvh, d = 4, 1024, 32, 8, 128
    before = FD.launches
    with cost.recording() as got:
        o = FD.flash_decode(_meta(b, 1, h, d), _meta(b, S, kvh, d),
                            _meta(b, S, kvh, d),
                            _meta(b, dtype=torch.int32))
    assert o.shape == (b, 1, h, d) and o.dtype == torch.bfloat16
    assert FD.launches == before
    # kv_len holds no values on meta: every cache row is charged
    assert got["flash_decode"]["flops"] == 4 * (b * S) * h * d
    assert got["flash_decode"]["bytes"] == 2 * (
        2 * b * h * d + 2 * b * S * kvh * d) + 4 * b


@pytest.mark.parametrize("init", [False, True])
def test_ssd_scan_meta_branch(init):
    b, s, nh, P, g, N, Q = 2, 1000, 64, 64, 1, 64, 128
    before = SSD.launches
    with cost.recording() as got:
        y, state = SSD.ssd_scan(
            _meta(b, s, nh, P), _meta(b, s, nh, dtype=torch.float32),
            _meta(nh, dtype=torch.float32), _meta(b, s, g, N),
            _meta(b, s, g, N), Q,
            _meta(b, nh, P, N, dtype=torch.float32) if init else None)
    assert y.shape == (b, s, nh, P) and y.dtype == torch.bfloat16
    assert state.shape == (b, nh, P, N) and state.dtype == torch.float32
    assert SSD.launches == before
    assert got["ssd_scan"]["flops"] == _old_ssd_flops(b, s, nh, P, N, Q)
    assert cost.ssd_flops(3, 37, 8, 16, 8, 16) == _old_ssd_flops(
        3, 37, 8, 16, 8, 16)


def test_attention_backward_charge_is_the_blocked_loops():
    """The training backward's formula against the products
    ``_flash_bwd`` does on the CPU."""
    from repro_torch.models.attention import _flash_bwd
    b, sq, g, m, hd = 2, 16, 2, 2, 16
    q, o, do = (torch.randn(b, sq, g, m, hd) for _ in range(3))
    k, v = torch.randn(b, sq, g, hd), torch.randn(b, sq, g, hd)
    L = torch.randn(b, g, m, sq)
    with FlopCounterMode(display=False) as fc:
        _flash_bwd(q, k, v, o, L, do, True, 8, 8)
    assert fc.get_total_flops() == cost.attention_bwd_flops(b, sq, sq,
                                                            g * m, hd)


# ---------------------------------------------------------------------------
# the meta scans
# ---------------------------------------------------------------------------

def _xlstm_params(cfg, defs, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return init_from_defs(defs, gen, "cpu")


def _to_meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta",
                       requires_grad=t.requires_grad)


def _grad_shapes(out, ins):
    loss = sum(o.float().sum() for o in out)
    grads = torch.autograd.grad(loss, ins, allow_unused=True)
    return [None if g is None else (tuple(g.shape), g.dtype) for g in grads]


def test_slstm_meta_scan_against_the_eager_scan():
    cfg = get_reduced_config("xlstm-350m").replace(dtype="float32")
    p = _xlstm_params(cfg, ssm.slstm_defs(cfg))
    b, s = 2, 24
    x = torch.randn(b, s, cfg.d_model, requires_grad=True)
    W, R = (p[k].requires_grad_() for k in ("W", "R"))
    with FlopCounterMode(display=False) as fc:
        y, st = ssm.slstm_cell_scan(cfg, p, x)
    eager_flops = fc.get_total_flops()
    eager = _grad_shapes((y,) + st, [x, W, R])

    pm = {k: _to_meta(v) for k, v in p.items() if k in ("W", "R", "b")}
    xm = _to_meta(x)
    with cost.recording() as got, FlopCounterMode(display=False) as fc:
        ym, stm = ssm.slstm_cell_scan(cfg, pm, xm)
    assert got["slstm_scan"]["calls"] == s
    # the projection outside the scan is counted as it runs; the step
    # is charged s times
    assert fc.get_total_flops() + got["slstm_scan"]["flops"] == eager_flops
    assert (ym.shape, ym.dtype) == (y.shape, y.dtype) and ym.is_meta
    assert [(t.shape, t.dtype) for t in stm] == \
        [(t.shape, t.dtype) for t in st]
    with cost.recording() as back:
        assert _grad_shapes((ym,) + stm, [xm, pm["W"], pm["R"]]) == eager
    assert back["slstm_scan"]["calls"] == s
    assert back["slstm_scan"]["flops"] > 0


def test_mlstm_meta_scan_against_the_eager_scan():
    b, s, nh, dh, chunk = 2, 40, 2, 16, 16
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(b, s, nh, dh, generator=gen, requires_grad=True)
               for _ in range(3))
    li, lf = (torch.randn(b, s, nh, generator=gen, requires_grad=True)
              for _ in range(2))
    with FlopCounterMode(display=False) as fc:
        h, st = ssm.mlstm_chunkwise(q, k, v, li, lf, chunk)
    eager_flops = fc.get_total_flops()
    eager = _grad_shapes((h,) + st, [q, k, v, li, lf])
    ins = [_to_meta(t) for t in (q, k, v, li, lf)]
    with cost.recording() as got, FlopCounterMode(display=False) as fc:
        hm, stm = ssm.mlstm_chunkwise(*ins, chunk)
    assert got["mlstm_chunks"]["calls"] == math.ceil(s / chunk)
    assert fc.get_total_flops() + got["mlstm_chunks"]["flops"] == eager_flops
    assert (hm.shape, hm.dtype) == (h.shape, h.dtype)
    assert [(t.shape, t.dtype) for t in stm] == \
        [(t.shape, t.dtype) for t in st]
    with cost.recording():
        assert _grad_shapes((hm,) + stm, ins) == eager


# ---------------------------------------------------------------------------
# cells, against the reference's own PartitionSpecs
# ---------------------------------------------------------------------------

class FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)


def _ref_bytes(sds, axes, mesh, rules, sizes):
    if isinstance(sds, dict):
        return sum(_ref_bytes(sds[k], axes[k], mesh, rules, sizes)
                   for k in sds)
    spec = tuple(rules.spec(mesh, axes, sds.shape))
    n = 1
    for i, dim in enumerate(sds.shape):
        entry = spec[i] if i < len(spec) else None
        entry = (entry,) if isinstance(entry, str) else tuple(entry or ())
        n *= -(-dim // math.prod(sizes[a] for a in entry))
    return n * np.dtype(sds.dtype).itemsize


def reference_argument_bytes(arch, shape_name, mesh_kind, uneven=False):
    """Per-device argument bytes from the JAX package's abstract trees
    and PartitionSpecs, nothing compiled."""
    cfg, shape = jax_config(arch), JAX_SHAPES[shape_name]
    dims, names = MESHES[mesh_kind]
    mesh, sizes = FakeMesh(dims, names), dict(zip(names, dims))
    rules = JaxRules().for_shape_kind(shape.kind)
    if uneven:
        rules = rules.with_uneven("heads", "kv_heads", "act_heads",
                                  "act_kv_heads")
    p = JM.abstract_params(cfg)
    trees = [(p, JM.param_axes(cfg))]
    if shape.kind == "train":
        trees.append((JO.abstract_opt_state(p),
                      JO.opt_state_axes(JM.param_axes(cfg))))
    trees.append((JM.input_specs(cfg, shape), JM.input_axes(cfg, shape)))
    return sum(_ref_bytes(t, a, mesh, rules, sizes) for t, a in trees)


CELLS = [("stablelm-1.6b", "train_4k", "single"),
         ("granite-moe-1b-a400m", "decode_32k", "single"),
         ("zamba2-1.2b", "long_500k", "single"),
         ("xlstm-350m", "prefill_32k", "single"),
         ("phi-3-vision-4.2b", "prefill_32k", "single"),
         ("yi-6b", "decode_32k", "multi")]


@pytest.mark.parametrize("arch,shape,mesh_kind", CELLS)
def test_cell_traces_at_full_width(arch, shape, mesh_kind):
    res = dryrun.run_cell(arch, shape, mesh_kind, save_hlo=False)
    assert res["status"] == "ok", res.get("traceback")
    assert not dist.is_initialized()
    assert res["n_devices"] == math.prod(MESHES[mesh_kind][0])
    assert res["mesh_shape"] == list(MESHES[mesh_kind][0])
    mem = res["memory"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "alias_bytes"}
    assert mem["argument_bytes"] == reference_argument_bytes(
        arch, shape, mesh_kind)
    assert mem["temp_bytes"] >= 0 and mem["output_bytes"] > 0
    if shape in ("decode_32k", "long_500k"):
        assert 0 < mem["alias_bytes"] < mem["argument_bytes"]
    assert res["flops_per_device"] > 0 and res["trace_s"] > 0
    assert set(res["collective_op_counts"]) <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert sum(res["collective_op_counts"].values()) > 0
    assert json.loads(json.dumps(res)) == res


def test_uneven_cell_argument_bytes():
    """phi3-medium-14b prefill_32k with its 40 heads and 10 kv heads
    sharded unevenly over 16: rank 0 holds the ceil, the bytes the
    reference's uneven PartitionSpecs give."""
    res = dryrun.run_cell("phi3-medium-14b", "prefill_32k", "single",
                          save_hlo=False, uneven_heads=True)
    assert res["status"] == "ok", res.get("traceback")
    assert res["memory"]["argument_bytes"] == reference_argument_bytes(
        "phi3-medium-14b", "prefill_32k", "single", uneven=True)


def test_main_writes_the_cell(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    assert dryrun.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k",
                        "--mesh", "single"]) == 0
    path = tmp_path / "single" / "stablelm-1.6b__decode_32k.json"
    res = json.loads(path.read_text())
    assert res["status"] == "ok" and res["arch"] == "stablelm-1.6b"
    assert (tmp_path / "single"
            / "stablelm-1.6b__decode_32k.json.comms.json.gz").exists()
    assert "done: 1 ok, 0 failed" in capsys.readouterr().out
    assert dryrun.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k",
                        "--mesh", "single", "--skip-existing"]) == 0
    assert "[skip]" in capsys.readouterr().out


def test_a_cell_that_does_not_apply_is_skipped():
    res = dryrun.run_cell("yi-6b", "long_500k", "single")
    assert res["status"] == "skipped" and "reason" in res


def test_no_fake_group_means_no_dry_run(monkeypatch):
    import builtins
    real = builtins.__import__

    def refuse(name, *args, **kwargs):
        if name.endswith("fake_pg"):
            raise ImportError(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", refuse)
    with pytest.raises(RuntimeError, match="fake process group"):
        with dryrun.fake_group(4):
            pass
    assert not dist.is_initialized()
