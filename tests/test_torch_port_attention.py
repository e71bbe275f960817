"""fit_tpu_torch.ops.rope_attention against fit_tpu.ops.fused_attention.

On the CPU the wrapper runs its plain PyTorch version, which is held against
the Pallas kernels (interpret mode off the TPU, as fit_tpu's own tests run
them) and their XLA oracle. All fp32, valid query rows only (padded query
rows are discarded downstream). Tolerance 3e-5: fp32 with another summation
order than XLA's, the bar of tests/test_torch_parity.py.

The backward is held against jax.grad through the same Pallas kernels'
custom VJP in each of fit_tpu's backward regimes, at the bar of
tests/test_fused_attention.py's gradient tests (5e-5), with an upstream
gradient on every query row.

The kernels themselves run only on a CUDA card: tests/test_torch_port_cuda.py
holds them against the plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fit_tpu.core.pos_embed import rope_freqs_2d
from fit_tpu.ops import fused_attention as jfa
from fit_tpu_torch.ops import launch_counts, reset_launches
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
    reset_launches()
    got = ra.qkv_rope_attention(
        torch.from_numpy(qkv), cos, sin, torch.from_numpy(lens), d**-0.5, h
    ).numpy()
    assert launch_counts()["rope_attention_fwd"] == 0  # a CPU tensor never reaches the kernel
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


# --- K1's lse and the backward K2 (plain versions here; the kernels run on
# the card in tests/test_torch_port_cuda.py) --------------------------------

GRAD_ATOL = 5e-5  # the bar of tests/test_fused_attention.py's gradient tests
H6, D16 = 6, 16  # hidden 96 over 6 heads


def _port_inputs(seed, t, lengths):
    qkv, fc, lens = make_inputs(seed, len(lengths), t, H6, D16, lengths)
    cos, sin = ra.split_rope_tables(torch.from_numpy(fc))
    g = np.random.default_rng(seed + 100).normal(size=(len(lengths), t, H6 * D16)).astype(np.float32)
    return qkv, fc, lens, cos, sin, g  # g is random on every row, padded rows too


def test_lse_matches_chunked_pallas_forward(monkeypatch):
    """lse2 of the plain forward == _qkv_forward_chunked(with_lse=True), the
    chunked Pallas kernel forced at T=256 by a 64-row chunk threshold."""
    monkeypatch.setenv("FIT_TPU_CHUNK_T", "64")
    lengths = (256, 200)
    qkv, fc, lens, cos, sin, _ = _port_inputs(7, 256, lengths)
    out, lse = ra.rope_attention_fwd(torch.from_numpy(qkv), cos, sin, torch.from_numpy(lens), D16**-0.5, H6, with_lse=True)
    assert lse.shape == (2, 256, H6) and lse.dtype == torch.float32
    jcos, jsin = jfa.split_rope_tables(jnp.asarray(fc))
    jout, jlse = jfa._qkv_forward_chunked(
        jnp.asarray(qkv).reshape(2, 256, 3, H6 * D16), jcos, jsin, jnp.asarray(lens), D16**-0.5, D16, True
    )
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL, rtol=0)  # padded rows too
    valid_rows_close(out.numpy(), np.asarray(jout), lens)


# (JAX regime, env, T, lengths): Pallas interpret at T=64; the single-pass
# chunked backward at T=256; the two-pass chunked backward at T=256.
GRAD_CASES = [
    ("pallas", {}, 64, (64, 50)),
    ("pallas", {}, 64, (33, 1)),
    ("single-pass", {"FIT_TPU_CHUNK_T": "64"}, 256, (256, 200)),
    ("single-pass", {"FIT_TPU_CHUNK_T": "64"}, 256, (128, 65)),
    ("two-pass", {"FIT_TPU_CHUNK_T": "64", "FIT_TPU_QCHUNK_T": "128", "FIT_TPU_SINGLE_BWD_T": "64"}, 256, (256, 200)),
    ("two-pass", {"FIT_TPU_CHUNK_T": "64", "FIT_TPU_QCHUNK_T": "128", "FIT_TPU_SINGLE_BWD_T": "64"}, 256, (128, 65)),
]


@pytest.mark.parametrize("regime,env,t,lengths", GRAD_CASES, ids=[f"{c[0]}-{c[3]}" for c in GRAD_CASES])
def test_backward_matches_jax_grad(monkeypatch, regime, env, t, lengths):
    """The autograd Function (K1 with lse forward, K2 backward; plain on the
    CPU) and the plain backward called directly, against jax.grad through
    qkv_rope_flash_attention in each of fit_tpu's backward regimes. Every
    query row carries gradient, padded rows included."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    qkv, fc, lens, cos, sin, g = _port_inputs(len(lengths) + t, t, lengths)
    jcos, jsin = jfa.split_rope_tables(jnp.asarray(fc))
    want = np.asarray(jax.grad(
        lambda x: jnp.sum(jfa.qkv_rope_flash_attention(x, jcos, jsin, jnp.asarray(lens), D16**-0.5, H6) * g)
    )(jnp.asarray(qkv)))

    x = torch.from_numpy(qkv).requires_grad_(True)
    reset_launches()
    out = ra.qkv_rope_attention(x, cos, sin, torch.from_numpy(lens), D16**-0.5, H6)
    (got,) = torch.autograd.grad(out, x, torch.from_numpy(g))
    assert not any(launch_counts().values())  # CPU tensors: the plain versions
    np.testing.assert_allclose(got.numpy(), want, atol=GRAD_ATOL, rtol=0)

    o, lse = ra.rope_attention_fwd(torch.from_numpy(qkv), cos, sin, torch.from_numpy(lens), D16**-0.5, H6, with_lse=True)
    direct = ra.rope_attention_bwd(torch.from_numpy(qkv), torch.from_numpy(g), o, lse, cos, sin, torch.from_numpy(lens), D16**-0.5, H6)
    np.testing.assert_allclose(direct.numpy(), want, atol=GRAD_ATOL, rtol=0)
    # keys at or past a row's length get no gradient
    c = H6 * D16
    for i, n in enumerate(lens):
        assert not direct[i, n:, c:].any()


def test_backward_matches_autograd_of_plain_forward():
    """The plain backward is the VJP of the plain forward (fp32, another
    order of the same sums), and padded query rows do reach the keys: with
    their upstream gradient zeroed, dk and dv change."""
    lengths = (40, 9)
    qkv, _, lens, cos, sin, g = _port_inputs(3, 40, lengths)
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = ra.rope_attention_reference(x, cos, sin, torch.from_numpy(lens), D16**-0.5, H6)
    (want,) = torch.autograd.grad(out, x, torch.from_numpy(g))
    o, lse = ra.rope_attention_reference(x.detach(), cos, sin, torch.from_numpy(lens), D16**-0.5, H6, with_lse=True)
    got = ra.rope_attention_backward_reference(x.detach(), torch.from_numpy(g), o, lse, cos, sin, torch.from_numpy(lens), D16**-0.5, H6)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    g_valid = g.copy()
    g_valid[1, 9:] = 0
    masked = ra.rope_attention_backward_reference(x.detach(), torch.from_numpy(g_valid), o, lse, cos, sin, torch.from_numpy(lens), D16**-0.5, H6)
    assert (masked[1, :9, H6 * D16 :] - got[1, :9, H6 * D16 :]).abs().max() > 1e-3


def test_inference_takes_the_forward_without_lse(monkeypatch):
    """No gradient wanted: one plain forward, no autograd Function."""
    qkv, _, lens, cos, sin, _ = _port_inputs(4, 32, (32, 20))
    calls = []
    real = ra.rope_attention_reference
    monkeypatch.setattr(ra, "rope_attention_reference", lambda *a, **k: calls.append(k) or real(*a, **k))
    x = torch.from_numpy(qkv).requires_grad_(True)
    with torch.inference_mode():
        ra.qkv_rope_attention(x, cos, sin, torch.from_numpy(lens), 0.25, H6)
    with torch.no_grad():
        ra.qkv_rope_attention(x, cos, sin, torch.from_numpy(lens), 0.25, H6)
    out = ra.qkv_rope_attention(x, cos, sin, torch.from_numpy(lens), 0.25, H6)
    assert [k.get("with_lse", False) for k in calls] == [False, False, True]
    assert out.grad_fn is not None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k2_scratch_layout(dtype):
    """K2's scratch in both dtypes: the rotated q and k head-major (2, B, H,
    T, d) in the activations' dtype, lse2 and delta (2, B, H, T rounded up
    to 64) in fp32."""
    qkv = torch.zeros((3, 100, 3 * 4 * 16), dtype=dtype)
    rot, stats = ra._k2_scratch(qkv, 4)
    assert (tuple(rot.shape), rot.dtype) == ((2, 3, 4, 100, 16), dtype)
    assert (tuple(stats.shape), stats.dtype) == ((2, 3, 4, 128), torch.float32)
    assert rot.is_contiguous() and stats.is_contiguous() and rot.device == stats.device == qkv.device


def test_backward_argument_checks():
    """K2's checks on g, out and lse, device-agnostic (CPU tensors here)."""
    qkv, _, lens, cos, sin, g = _port_inputs(5, 16, (16, 16))
    q, gt = torch.from_numpy(qkv), torch.from_numpy(g)
    out, lse = ra.rope_attention_reference(q, cos, sin, torch.from_numpy(lens), 0.25, H6, with_lse=True)
    ra._check_bwd_args(q, gt, out, lse, H6)
    with pytest.raises(ValueError, match="lse must be"):
        ra._check_bwd_args(q, gt, out, lse[..., :-1], H6)
    with pytest.raises(ValueError, match="out must be"):
        ra._check_bwd_args(q, gt, out.bfloat16(), lse, H6)
    with pytest.raises(ValueError, match="contiguous"):
        ra._check_bwd_args(q, gt.transpose(0, 1).contiguous().transpose(0, 1), out, lse, H6)


# --- K1's strided entries: masked_attention (RoPE off, (B, H, T, d)) and
# rope_flash_attention ((B, T, H, d)); plain versions here ----------------

from fit_tpu.ops import attention as jat  # noqa: E402
from fit_tpu_torch.ops import attention as at  # noqa: E402

MASK_ATOL = 2e-5  # fp32, another summation order than XLA's and the interpreted kernel's
# (T, lengths): full, padded, a one-key row, a row past a 128-row block
MASK_CASES = [(256, (256, 256)), (256, (240, 130)), (256, (256, 1)), (128, (100, 128))]


def _bhtd(seed, t, lengths, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(len(lengths), H6, t, D16)).astype(dtype) for _ in range(3))
    mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    return q, k, v, mask


def _valid_bhtd(got, want, lengths, atol):
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(got[i, :, :n], want[i, :, :n], atol=atol, rtol=0)


@pytest.mark.parametrize("backend", ["xla", "flash"])
@pytest.mark.parametrize("t,lengths", MASK_CASES, ids=[str(c[1]) for c in MASK_CASES])
def test_masked_attention_matches_fit_tpu(backend, t, lengths):
    """The plain version against fit_tpu's masked_attention: the XLA
    backend and the Pallas _flash_kernel in interpret mode. Valid query rows
    only (the flash kernel writes zeros on wholly padded query blocks)."""
    q, k, v, mask = _bhtd(t + lengths[1], t, lengths)
    reset_launches()
    got = at.masked_attention(*(torch.from_numpy(a) for a in (q, k, v, mask))).numpy()
    assert launch_counts()["masked_attention"] == 0
    want = np.asarray(jat.masked_attention(*(jnp.asarray(a) for a in (q, k, v, mask)), backend=backend))
    assert got.shape == want.shape == q.shape
    _valid_bhtd(got, want, lengths, MASK_ATOL)


@pytest.mark.parametrize("t,lengths", MASK_CASES, ids=[str(c[1]) for c in MASK_CASES])
def test_masked_attention_gradient_matches_jax_grad_of_flash(t, lengths):
    """The autograd Function's recompute backward against jax.grad through
    the flash path's custom VJP, with an upstream gradient on every row
    (both zero it on padded query rows)."""
    q, k, v, mask = _bhtd(2 * t + lengths[1], t, lengths)
    g = np.random.default_rng(t).normal(size=q.shape).astype(np.float32)
    want = jax.grad(
        lambda a, b, c: jnp.sum(jat.masked_attention(a, b, c, jnp.asarray(mask), backend="flash") * g),
        argnums=(0, 1, 2),
    )(*(jnp.asarray(a) for a in (q, k, v)))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = torch.autograd.grad(at.masked_attention(*xs, torch.from_numpy(mask)), xs, torch.from_numpy(g))
    for gx, wx in zip(got, want):
        _valid_bhtd(gx.numpy(), np.asarray(wx), lengths, GRAD_ATOL)


def test_masked_attention_bf16_and_lengths_entry():
    """bf16 operands against fit_tpu's bf16 XLA path (one bf16 rounding of
    p and of the output on values of order 1), and ``lengths`` in place of
    the mask."""
    lengths = (256, 130)
    q, k, v, mask = _bhtd(11, 256, lengths)
    xs = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    got = at.masked_attention(*xs, lengths=torch.tensor(lengths, dtype=torch.int32))
    assert got.dtype == torch.bfloat16
    want = jat.masked_attention(*(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in xs), jnp.asarray(mask), backend="xla")
    _valid_bhtd(got.float().numpy(), np.asarray(want, np.float32), lengths, 3e-2)


def test_masked_attention_mask_contract():
    q, k, v, mask = _bhtd(12, 16, (16, 9))
    lengths = at.mask_to_lengths(torch.from_numpy(mask))
    assert lengths.dtype == torch.int32 and lengths.tolist() == [16, 9]
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jat.mask_to_lengths(jnp.asarray(mask))))
    holed = mask.copy()
    holed[0, 3] = False
    with pytest.raises(ValueError, match="prefix"):
        at.masked_attention(*(torch.from_numpy(a) for a in (q, k, v, holed)))
    full = at.masked_attention(*(torch.from_numpy(a) for a in (q, k, v)))  # no mask: every key
    ones = at.masked_attention(*(torch.from_numpy(a) for a in (q, k, v)), torch.ones(2, 16, dtype=torch.bool))
    torch.testing.assert_close(full, ones, rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["transpose", "direct"])
@pytest.mark.parametrize("lengths", [(64, 64), (50, 1)], ids=["full", "padded"])
def test_rope_flash_attention_matches_fit_tpu(monkeypatch, layout, lengths):
    """The plain version of rope_flash_attention against fit_tpu's, in both
    of its layouts (FIT_TPU_ATTN_LAYOUT: the (B, H, T, d) _kernel behind
    transposes, and _kernel_direct on (B, T, H, d) blocks), on (B, T, H, d)
    views of one projection; valid rows only."""
    monkeypatch.setenv("FIT_TPU_ATTN_LAYOUT", layout)
    t = 64
    qkv, fc, lens, cos, sin, _ = _port_inputs(20 + lengths[1], t, lengths)
    q, k, v = torch.from_numpy(qkv).view(2, t, 3, H6, D16).unbind(2)
    reset_launches()
    got = ra.rope_flash_attention(q, k, v, cos, sin, torch.from_numpy(lens), D16**-0.5)
    assert not any(launch_counts().values())
    jcos, jsin = jfa.split_rope_tables(jnp.asarray(fc))
    want = jfa.rope_flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)), jcos, jsin, jnp.asarray(lens), D16**-0.5)
    assert got.shape == want.shape == (2, t, H6, D16)
    valid_rows_close(got.numpy(), np.asarray(want), lens)


def test_rope_flash_attention_gradient_matches_jax_grad():
    """Stacked into the packed autograd Function: its gradient in q, k, v
    against jax.grad through fit_tpu's rope_flash_attention."""
    t, lengths = 64, (64, 33)
    qkv, fc, lens, cos, sin, _ = _port_inputs(30, t, lengths)
    g = np.random.default_rng(31).normal(size=(2, t, H6, D16)).astype(np.float32)
    q, k, v = (a[:, :, 0] for a in np.split(qkv.reshape(2, t, 3, H6, D16), 3, axis=2))
    jcos, jsin = jfa.split_rope_tables(jnp.asarray(fc))
    want = jax.grad(
        lambda a, b, c: jnp.sum(jfa.rope_flash_attention(a, b, c, jcos, jsin, jnp.asarray(lens), D16**-0.5) * g),
        argnums=(0, 1, 2),
    )(*(jnp.asarray(a) for a in (q, k, v)))
    xs = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True) for a in (q, k, v)]
    out = ra.rope_flash_attention(*xs, cos, sin, torch.from_numpy(lens), D16**-0.5)
    got = torch.autograd.grad(out, xs, torch.from_numpy(g))
    for gx, wx in zip(got, want):
        np.testing.assert_allclose(gx.numpy(), np.asarray(wx), atol=GRAD_ATOL, rtol=0)


def _strided_views():
    base = torch.zeros((2, 16, 3 * H6 * D16))
    return list(base.view(2, 16, 3, H6, D16).unbind(2))


@pytest.mark.parametrize(
    "bad,error,match",
    [
        (lambda v: v, None, None),
        (lambda v: [v[0].half()] + v[1:], TypeError, "bf16 or fp32"),
        (lambda v: [x[..., :12] for x in v], ValueError, "multiple of 8"),
        (lambda v: [v[0][:, :8]] + v[1:], ValueError, "q is torch.float32"),
        (lambda v: [torch.zeros(2, 16, H6, 2 * D16)[..., ::2]] + v[1:], ValueError, "contiguous"),
        (lambda v: [torch.zeros(2, 16 * H6 * D16 + 4)[:, :-4].view(2, 16, H6, D16)] + v[1:], ValueError, "multiples of 8"),
        (lambda v: [torch.zeros(2 * 16 * H6 * D16 + 1)[1:].view(2, 16, H6, D16)] + v[1:], ValueError, "16-byte"),
    ],
    ids=["ok", "dtype", "d%8", "shape", "last-dim", "strides", "aligned"],
)
def test_strided_operand_checks(bad, error, match):
    """The checks K1's strided entries make before a launch (device-agnostic,
    so they run here on CPU tensors): views of a packed projection pass,
    with any batch, token and head strides that are multiples of 8 elements."""
    views = bad(_strided_views())
    if error is None:
        ra._check_views(*views)
        ra._check_views(*(x.transpose(1, 2).transpose(1, 2) for x in views))
        assert ra._bth_strides(views[0]) == [16 * 3 * H6 * D16, 3 * H6 * D16, D16]
        return
    with pytest.raises(error, match=match):
        ra._check_views(*views)
