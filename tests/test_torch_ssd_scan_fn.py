"""``SSDScanFn``, the SSD scan with a backward (``repro_torch.models.ssm``),
against ``jax.vjp`` of the JAX package's ``repro.models.ssm.ssd_scan``, on
the CPU, where its forward is the kernel's plain version; and the choice
between the Function and the kernel's wrapper. Inputs come from numpy
seeds. Each test states its tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.models import ssm as tssm


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))



@pytest.mark.parametrize("s,nh,g,with_init,state_grad", [
    (40, 4, 1, False, False), (40, 4, 1, True, True), (32, 4, 2, True, True),
    (21, 6, 2, False, True)],
    ids=["ragged", "ragged-init", "grouped-init", "grouped-ragged"])
def test_ssd_scan_fn_matches_jax_vjp(s, nh, g, with_init, state_grad):
    """y, the final state and the gradients of x, dt, A, B, C (and of
    init_state when given) against ``jax.vjp`` of the JAX package's
    ``ssd_scan``, chunks of 16 (s = 40 and 21 end in a ragged chunk); the
    final state gets a cotangent, or None as in training. fp32, each
    value within 1e-5 of its largest entry (the gradients sum over the
    chunk in other orders). Each gradient comes in its input's dtype."""
    rng = np.random.default_rng(s + nh + g)
    b, P, N, Q = 2, 16, 8, 16
    x = rng.standard_normal((b, s, nh, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(nh) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, s, g, N)).astype(np.float32)
    C = rng.standard_normal((b, s, g, N)).astype(np.float32)
    init = rng.standard_normal((b, nh, P, N)).astype(np.float32) \
        if with_init else None
    dy = rng.standard_normal((b, s, nh, P)).astype(np.float32)
    dst = rng.standard_normal((b, nh, P, N)).astype(np.float32)
    args = [x, dt, A, B, C] + ([init] if with_init else [])

    def jfn(*a):
        return jssm.ssd_scan(*a[:5], Q, a[5] if with_init else None)

    (y_j, st_j), vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    grads_j = vjp((jnp.asarray(dy), jnp.asarray(dst) if state_grad
                   else jnp.zeros_like(st_j)))
    ins = [_t(a).requires_grad_() for a in args]
    y, st = tssm.SSDScanFn.apply(*ins[:5], Q,
                                 ins[5] if with_init else None)
    outs, cots = ([y, st], [_t(dy), _t(dst)]) if state_grad \
        else ([y], [_t(dy)])
    grads_t = torch.autograd.grad(outs, ins, cots)
    names = ["dx", "ddt", "dA", "dB", "dC", "dinit"]
    for name, got, exp in zip(["y", "state"] + names,
                              [y.detach(), st.detach()] + list(grads_t),
                              [y_j, st_j] + list(grads_j)):
        exp = np.asarray(exp)
        assert got.dtype == torch.float32 and got.shape == exp.shape, name
        err = np.abs(got.numpy() - exp).max()
        assert err <= 1e-5 * np.abs(exp).max(), (name, err)


def test_ssd_scan_fn_keeps_each_inputs_dtype_and_the_kernels_roundings():
    """bf16 x, B and C with fp32 dt and A, as the model feeds them: the
    gradients come in bf16 and fp32 as their inputs, and match ``jax.vjp``
    of the JAX package's bf16 ``ssd_scan`` within 2e-2 of the largest
    entry (tests/test_kernels.py's bf16 tolerance: the same roundings to
    bf16, summed in other orders)."""
    rng = np.random.default_rng(9)
    b, s, nh, g, P, N, Q = 2, 40, 4, 1, 16, 8, 16
    bf = jnp.bfloat16
    x, B, C, dy = (rng.standard_normal(sh).astype(np.float32) for sh in
                   ((b, s, nh, P), (b, s, g, N), (b, s, g, N),
                    (b, s, nh, P)))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(nh) * 0.3).astype(np.float32)
    jx, jB, jC, jdy = (jnp.asarray(a).astype(bf) for a in (x, B, C, dy))
    (y_j, st_j), vjp = jax.vjp(
        lambda x, dt, A, B, C: jssm.ssd_scan(x, dt, A, B, C, Q),
        jx, jnp.asarray(dt), jnp.asarray(A), jB, jC)
    grads_j = vjp((jdy, jnp.zeros_like(st_j)))
    ins = [_t(x).bfloat16(), _t(dt), _t(A), _t(B).bfloat16(),
           _t(C).bfloat16()]
    ins = [t.requires_grad_() for t in ins]
    y, _ = tssm.SSDScanFn.apply(*ins, Q, None)
    grads_t = torch.autograd.grad(y, ins, _t(dy).bfloat16())
    assert y.dtype == torch.bfloat16
    for name, got, inp, exp in zip(["dx", "ddt", "dA", "dB", "dC"],
                                   grads_t, ins, grads_j):
        assert got.dtype == inp.dtype, name
        exp = np.asarray(exp.astype(jnp.float32))
        err = np.abs(got.float().numpy() - exp).max()
        assert err <= 2e-2 * np.abs(exp).max(), (name, err)


def test_ssd_scan_takes_the_function_only_when_a_gradient_is_wanted(
        monkeypatch):
    """``models.ssm.ssd_scan`` goes through ``SSDScanFn`` when an input
    requires grad and grad is on, and calls the kernel's wrapper directly
    otherwise. Inside the Function the wrapper runs with grad off, so its
    guard (ROADMAP C5) lets a CUDA tensor through: shown by a stand-in for
    the wrapper."""
    seen = []

    def fake(x, dt, A, B, C, *, chunk, init_state):
        seen.append(torch.is_grad_enabled())
        return SSD.ssd_scan_plain(x, dt, A, B, C, chunk, init_state)

    monkeypatch.setattr(tssm.ops, "ssd_bshn", fake)
    x = torch.randn(1, 16, 2, 16)
    dt, A = torch.rand(1, 16, 2), -torch.rand(2)
    B, C = torch.randn(1, 16, 1, 8), torch.randn(1, 16, 1, 8)
    y, _ = tssm.ssd_scan(x, dt, A, B, C, 8)
    assert y.grad_fn is None and seen == [True]
    y, _ = tssm.ssd_scan(x.requires_grad_(), dt, A, B, C, 8)
    assert type(y.grad_fn).__name__ == "SSDScanFnBackward" \
        and seen == [True, False]
    with torch.no_grad():
        tssm.ssd_scan(x, dt, A, B, C, 8)
    assert seen == [True, False, False]
    (dx,) = torch.autograd.grad(y.sum(), (x,))
    assert torch.isfinite(dx).all()
