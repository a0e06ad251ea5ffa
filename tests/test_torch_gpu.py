"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each skips without a CUDA card (as everywhere on a CPU-only
machine). This file imports no JAX, so on the GPU machine, which has none,
it runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import pytest
import torch

from tts_max_tpu_torch.models.llama import _quantize_kv
from tts_max_tpu_torch.ops.attention import (
    KERNEL_TOL,
    causal_attention,
    decode_attention,
)
from tts_max_tpu_torch.ops.flash_attention import flash_attention
from tts_max_tpu_torch.ops.flash_decode import flash_decode_attention


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only on the GPU)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64), (torch.float32, 128)])
def test_flash_attention_kernel_matches_plain(dtype, d):
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 150, h, d, generator=g, device="cuda").to(dtype)
               for h in (8, 2, 2))
    for causal in (True, False):
        out = flash_attention(q, k, v, causal=causal)
        ref = causal_attention(q, k, v, causal=causal)
        rtol, atol = KERNEL_TOL[dtype]
        torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_decode_kernel_matches_plain(d, quant):
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(3, 32, d, generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(3, 300, 8, d, generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    lengths = torch.tensor([1, 300, 77], dtype=torch.int32, device="cuda")
    if quant:
        k, v = _quantize_kv(k), _quantize_kv(v)
    out = flash_decode_attention(q, k, v, lengths)
    ref = decode_attention(q, k, v, lengths)
    rtol, atol = KERNEL_TOL[torch.bfloat16]
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)
