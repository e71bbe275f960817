"""fit_tpu_torch.ops.rope_attention against fit_tpu.ops.fused_attention.

On the CPU the wrapper runs its plain PyTorch version, which is held against
the Pallas kernels (interpret mode off the TPU, as fit_tpu's own tests run
them) and their XLA oracle. All fp32, valid query rows only (padded query
rows are discarded downstream). Tolerance 3e-5: fp32 with another summation
order than XLA's, the bar of tests/test_torch_parity.py.

The kernel itself runs only on a CUDA card: tests/test_torch_port_cuda.py
holds it against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fit_tpu.core.pos_embed import rope_freqs_2d
from fit_tpu.ops import fused_attention as jfa
from fit_tpu_torch.ops import rope_attention as ra

ATOL = 3e-5


def make_inputs(seed, b, t, h, d, lengths):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, t, 3 * h * d)).astype(np.float32)
    side = int(np.ceil(np.sqrt(t)))
    fc = np.zeros((t, d), np.float32)
    fc[:] = rope_freqs_2d(d, side, side)[:t]
    fc = np.broadcast_to(fc, (b, t, d)).copy()
    return qkv, fc, np.asarray(lengths, np.int32)


def valid_rows_close(got, want, lengths, atol=ATOL):
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=atol, rtol=0)


def test_split_rope_tables_and_rotation_match():
    fc = np.random.default_rng(0).normal(size=(2, 5, 8)).astype(np.float32)
    cos, sin = ra.split_rope_tables(torch.from_numpy(fc))
    jcos, jsin = jfa.split_rope_tables(jnp.asarray(fc))
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))
    x = np.arange(1, 9, dtype=np.float32)[None]
    np.testing.assert_array_equal(
        ra.rotate_pairs(torch.from_numpy(x)).numpy(), x @ np.asarray(jfa.rotation_matrix(8))
    )


CASES = [
    # (H, d, T, lengths): d=16 and XL's d=72; full and padded rows
    (2, 16, 32, (32, 32)),
    (2, 16, 32, (20, 1)),
    (2, 72, 32, (32, 32)),
    (2, 72, 32, (32, 7)),
]


@pytest.mark.parametrize("h,d,t,lengths", CASES)
def test_reference_matches_qkv_pallas_kernel(h, d, t, lengths):
    qkv, fc, lens = make_inputs(0, len(lengths), t, h, d, lengths)
    cos, sin = ra.split_rope_tables(torch.from_numpy(fc))
    ra.reset_launches()
    got = ra.qkv_rope_attention(
        torch.from_numpy(qkv), cos, sin, torch.from_numpy(lens), d**-0.5, h
    ).numpy()
    assert ra.launches == 0  # a CPU tensor never reaches the kernel
    jcos, jsin = jfa.split_rope_tables(jnp.asarray(fc))
    want = np.asarray(
        jfa.qkv_rope_flash_attention(jnp.asarray(qkv), jcos, jsin, jnp.asarray(lens), d**-0.5, h)
    )
    assert got.shape == want.shape == (len(lengths), t, h * d)
    valid_rows_close(got, want, lens)


@pytest.mark.parametrize("h,d,t,lengths", CASES)
def test_reference_matches_split_kernel_and_xla_oracle(h, d, t, lengths):
    b = len(lengths)
    qkv, fc, lens = make_inputs(1, b, t, h, d, lengths)
    cos, sin = ra.split_rope_tables(torch.from_numpy(fc))
    got = ra.rope_attention_reference(
        torch.from_numpy(qkv).reshape(b, t, 3, h * d), cos, sin, torch.from_numpy(lens), d**-0.5, h
    ).numpy()
    q, k, v = (jnp.asarray(a) for a in np.split(qkv.reshape(b, t, 3, h, d), 3, axis=2))
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]
    jcos, jsin = jfa.split_rope_tables(jnp.asarray(fc))
    split = np.asarray(jfa.rope_flash_attention(q, k, v, jcos, jsin, jnp.asarray(lens), d**-0.5))
    oracle, _ = jfa._xla_reference(q, k, v, jcos, jsin, jnp.asarray(lens), d**-0.5)
    valid_rows_close(got, split.reshape(b, t, h * d), lens)
    valid_rows_close(got, np.asarray(oracle).reshape(b, t, h * d), lens)


def test_padded_query_rows_are_finite():
    """Padded rows take softmax over the valid keys too, never an empty one."""
    qkv, fc, lens = make_inputs(2, 2, 16, 2, 16, (3, 16))
    cos, sin = ra.split_rope_tables(torch.from_numpy(fc))
    out = ra.qkv_rope_attention(torch.from_numpy(qkv), cos, sin, torch.from_numpy(lens), 0.25, 2)
    assert torch.isfinite(out).all()


def test_bf16_reference_keeps_dtype():
    qkv, fc, lens = make_inputs(3, 2, 16, 2, 16, (16, 9))
    cos, sin = ra.split_rope_tables(torch.from_numpy(fc))
    x = torch.from_numpy(qkv).bfloat16()
    out = ra.qkv_rope_attention(x, cos, sin, torch.from_numpy(lens), 0.25, 2)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 16, 32)
    want = ra.rope_attention_reference(x.float(), cos, sin, torch.from_numpy(lens), 0.25, 2)
    # one bf16 rounding of the output (8 mantissa bits) on values of order 1
    valid_rows_close(out.float().numpy(), want.numpy(), lens, atol=2e-2)


def test_nvcc_missing_raises_clear_error(monkeypatch):
    from fit_tpu_torch.ops import _build

    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()



def _good_args(b=2, t=16, h=2, d=16):
    qkv, fc, lens = make_inputs(6, b, t, h, d, (t,) * b)
    cos, sin = ra.split_rope_tables(torch.from_numpy(fc))
    return [torch.from_numpy(qkv), cos, sin, torch.from_numpy(lens)]


@pytest.mark.parametrize(
    "bad,heads,error,match",
    [
        (lambda a: [a[0].half()] + a[1:], 2, TypeError, "bf16 or fp32"),
        (lambda a: [a[0][..., :-2]] + a[1:], 2, ValueError, "divisible"),
        (lambda a: _good_args(d=12), 2, ValueError, "multiple of 8"),
        (lambda a: _good_args(h=1, d=136), 1, ValueError, "at most 128"),
        (lambda a: [a[0], a[1][:, :8], a[2], a[3]], 2, ValueError, "cos must be fp32"),
        (lambda a: [a[0], a[1], a[2].double(), a[3]], 2, ValueError, "sin must be fp32"),
        (lambda a: a[:3] + [a[3].long()], 2, ValueError, "int32"),
        (lambda a: [a[0].transpose(0, 1).contiguous().transpose(0, 1)] + a[1:], 2, ValueError, "contiguous"),
        (lambda a: [torch.zeros(a[0].numel() + 1)[1:].view(a[0].shape)] + a[1:], 2, ValueError, "16-byte"),
        (lambda a: a[:3] + [torch.tensor([16, 0], dtype=torch.int32)], 2, ValueError, "at least 1"),
    ],
    ids=["dtype", "width", "d%8", "d>128", "cos", "sin", "lengths", "contiguous", "aligned", "zero-length"],
)
def test_kernel_argument_checks(bad, heads, error, match):
    """The checks the wrapper makes before a launch; they are device-agnostic,
    so they run here on CPU tensors (the launch itself needs a card)."""
    args = _good_args()
    assert ra._check_cuda_args(*args, num_heads=2, check_lengths=True) == 16
    with pytest.raises(error, match=match):
        ra._check_cuda_args(*bad(args), num_heads=heads, check_lengths=True)
