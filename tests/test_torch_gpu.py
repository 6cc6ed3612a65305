"""The CUDA kernels against their plain versions, on a card.

Marked ``gpu``: each test decides inside itself whether there is a CUDA
device and skips without one. The module imports torch and the port only
(no JAX), so it runs on a machine with the card:

    python -m pytest -m gpu tests/test_torch_gpu.py

bf16 inputs; tolerance 2e-2, tests/test_kernels.py's bf16 one.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_decode as FD


@pytest.mark.gpu
def test_cuda_kernels_match_plain():
    """Ragged lengths, GQA, a q_offset and every head dim group the
    serving path uses; flash-decode never reads past kv_len."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev) \
            .to(torch.bfloat16)

    for b, sq, h, kvh, d, off in [(2, 100, 4, 2, 16, 0), (2, 64, 8, 8, 64, 0),
                                  (1, 33, 4, 1, 128, 7)]:
        q, k, v = rnd(b, sq, h, d), rnd(b, sq + off, kvh, d), \
            rnd(b, sq + off, kvh, d)
        out = FA.flash_attention(q, k, v, q_offset=off)
        exp = FA.flash_attention_plain(q, k, v, q_offset=off)
        torch.testing.assert_close(out.float(), exp.float(), rtol=2e-2,
                                   atol=2e-2)
        kv_len = torch.randint(1, sq + 1, (b,), generator=gen, device=dev,
                               dtype=torch.int32)
        out = FD.flash_decode(q[:, :1], k, v, kv_len)
        exp = FD.flash_decode_plain(q[:, :1], k, v, kv_len)
        torch.testing.assert_close(out.float(), exp.float(), rtol=2e-2,
                                   atol=2e-2)
        # the kernel stops at kv_len: rows past it are never read
        poisoned_k, poisoned_v = k.clone(), v.clone()
        for row, n in enumerate(kv_len.tolist()):
            poisoned_k[row, n:] = float("nan")
            poisoned_v[row, n:] = float("nan")
        again = FD.flash_decode(q[:, :1], poisoned_k, poisoned_v, kv_len)
        torch.testing.assert_close(again, out, rtol=0, atol=0)
