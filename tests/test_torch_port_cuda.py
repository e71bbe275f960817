"""The CUDA kernel of fit_tpu_torch on the card, held against its plain
PyTorch version. These tests need a CUDA card and skip elsewhere. The file
imports no jax, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Tolerances (max abs error on valid query rows, against the fp32 plain
version): 1e-4 for fp32 (fp32 FMA dots, another summation order), 3e-2 for
bf16 (bf16 rounding of the rotated q/k, of p and of the output, the bound
fit_tpu uses for its bf16 dot kernels).
"""

import numpy as np
import pytest
import torch

from fit_tpu_torch.core.pos_embed import rope_freqs_2d
from fit_tpu_torch.ops import rope_attention as ra


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_inputs(seed, h, d, t, lengths, device, dtype):
    b = len(lengths)
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(b, t, 3 * h * d)).astype(np.float32))
    side = int(np.ceil(np.sqrt(t)))
    fc = torch.from_numpy(rope_freqs_2d(d, side, side)[:t].astype(np.float32))
    cos, sin = ra.split_rope_tables(fc.expand(b, t, d))
    lens = torch.tensor(lengths, dtype=torch.int32)
    return (qkv.to(device, dtype), cos.to(device), sin.to(device), lens.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize(
    "h,d,t,lengths",
    [
        (16, 72, 256, (256, 256, 200, 130, 64, 1, 255, 65)),  # XL, 256^2, padded rows
        (16, 72, 1024, (1024, 700)),  # XL, 512^2 extrapolation
        (12, 64, 256, (256, 31)),  # S/B/L head dim
        (2, 16, 40, (40, 33, 17)),  # tile tails: T not a multiple of 64
        (4, 32, 100, (100, 57)),  # the other compiled paddings: d = 32 ...
        (4, 40, 64, (64, 5)),  # ... d = 40 padded to 64 ...
        (2, 128, 128, (128, 70)),  # ... and d = 128
    ],
)
def test_kernel_matches_plain_version(cuda_device, dtype, atol, h, d, t, lengths):
    qkv, cos, sin, lens = make_inputs(0, h, d, t, lengths, cuda_device, dtype)
    ra.reset_launches()
    got = ra.qkv_rope_attention(qkv, cos, sin, lens, d**-0.5, h)
    torch.cuda.synchronize()
    assert ra.launches == 1
    assert got.dtype == dtype and got.shape == (len(lengths), t, h * d)
    want = ra.rope_attention_reference(qkv.float(), cos, sin, lens, d**-0.5, h)
    assert torch.isfinite(got).all()
    for i, n in enumerate(lengths):
        err = (got[i, :n].float() - want[i, :n]).abs().max().item()
        assert err <= atol, f"row {i} (length {n}): max abs err {err} > {atol}"


@pytest.mark.cuda
def test_kernel_rejects_bad_arguments(cuda_device):
    qkv, cos, sin, _ = make_inputs(1, 2, 16, 16, (16, 16), cuda_device, torch.float32)
    ones = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="at least 1"):
        ra.qkv_rope_attention(qkv, cos, sin, torch.tensor([16, 0], dtype=torch.int32, device=cuda_device), 0.25, 2)
    with pytest.raises(TypeError):
        ra.qkv_rope_attention(qkv.half(), cos, sin, ones, 0.25, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ra.qkv_rope_attention(qkv, cos.transpose(1, 2).contiguous().transpose(1, 2), sin, ones, 0.25, 2)
    with pytest.raises(ValueError, match="int32"):
        ra.qkv_rope_attention(qkv, cos, sin, ones.long(), 0.25, 2)
