"""The CUDA kernels of fit_tpu_torch on the card, held against their plain
PyTorch versions. These tests need a CUDA card and skip elsewhere. The file
imports no jax, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Tolerances, against the plain versions on the same inputs:
- attention (max abs error on valid query rows, against the fp32 plain
  version): 1e-4 for fp32 (3xTF32 tensor-core products, ~2^-22 relative,
  another summation order), 3e-2
  for bf16 (bf16 rounding of the rotated q/k, of p and of the output, the
  bound fit_tpu uses for its bf16 dot kernels); the same for K1's strided
  (B, T, H, d) and (B, H, T, d) operands with RoPE and without it, and
  for the gradients through them (max abs over max |plain|); the bf16
  kernel over every layout, RoPE on and off, lse on and off, every
  compiled padding and T from 1 to 4096 at 3e-2, two launches bit for bit
  equal, and K2 fed by its lse within 3e-2 of max |exact VJP|; the fp32
  kernel over every layout, RoPE on and off, lse on and off, every
  compiled padding and T from 1 to 1024 at 1e-4, two launches bit for bit
  equal, and the fp32 K2 fed by its lse within 1e-4 of max(1, max |exact
  VJP|);
- K1's lse and the backward K2 (dq, dk, dv each, every row): max abs
  error over max(1, max |plain|) within 1e-4 in fp32, over max |plain|
  within 3e-2 in bf16 (bf16 rounding of the rotated q/k, of p, of ds and of
  the stored gradient); keys at or past a row's length get exactly 0; the
  bf16 K2 over every compiled padding and T from 1 to 4096 (at T 1, where
  dq and dk are 0 but for rounding, against max |plain dv|), and two K2
  calls bit for bit equal;
- the row kernels with int8 epilogue: codes within one step, on at most
  1e-3 of them plus one (a LayerNorm sum taken in another order can move a
  value across a rounding boundary), row scales within 1e-6 relative, and
  two launches bit for bit equal;
- the row kernels without it: one bf16 ulp in bf16 (the same fp32 value,
  rounded once), a value under 2^-8 in magnitude judged at the ulp of 2^-8
  (where shift + n * (1 + scale) cancels to near zero, fp32 sums taken in
  another order differ by ~1e-7, many ulps of the tiny result); 1e-5 in
  fp32 (the LayerNorm sums' order).
"""

import numpy as np
import pytest
import torch

from fit_tpu_torch.core.pos_embed import rope_freqs_2d
from fit_tpu_torch.ops import attention as attn
from fit_tpu_torch.ops import fused_adaln, quant
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


GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize(
    "h,d,t,lengths",
    [
        (12, 64, 256, (256, 200, 1, 129)),  # FiT-B/2 training, a one-key row
        (12, 64, 96, (96, 50, 1)),  # a token bucket: T not a multiple of 64
        (12, 64, 32, (32, 17)),
        (16, 72, 256, (256, 130, 1)),  # XL's d = 72, padded to 80
        (16, 72, 1024, (1024, 700)),
        (2, 16, 40, (40, 1)),  # the other compiled paddings
        (2, 128, 128, (128, 70)),
    ],
)
def test_lse_and_backward_match_plain_versions(cuda_device, dtype, h, d, t, lengths):
    qkv, cos, sin, lens = make_inputs(2, h, d, t, lengths, cuda_device, dtype)
    g = torch.randn((len(lengths), t, h * d), generator=torch.Generator(cuda_device).manual_seed(1), device=cuda_device).to(dtype)
    ra.reset_launches()
    out, lse = ra.rope_attention_fwd(qkv, cos, sin, lens, d**-0.5, h, with_lse=True)
    dqkv = ra.rope_attention_bwd(qkv, g, out, lse, cos, sin, lens, d**-0.5, h)
    torch.cuda.synchronize()
    assert (ra.launches, ra.bwd_launches) == (1, 1)
    assert torch.equal(out, ra.rope_attention_fwd(qkv, cos, sin, lens, d**-0.5, h))  # lse changes nothing else
    _, lse_want = ra.rope_attention_reference(qkv, cos, sin, lens, d**-0.5, h, with_lse=True)
    tol = GRAD_REL[dtype]
    assert (lse - lse_want).abs().max().item() <= tol * max(1.0, lse_want.abs().max().item())
    want = ra.rope_attention_backward_reference(qkv, g, out, lse, cos, sin, lens, d**-0.5, h).float()
    got = dqkv.float()
    assert dqkv.dtype == dtype and torch.isfinite(got).all()
    c = h * d
    for i in range(3):
        part, ref = got[..., i * c : (i + 1) * c], want[..., i * c : (i + 1) * c]
        denom = ref.abs().max().item() if dtype == torch.bfloat16 else max(1.0, ref.abs().max().item())
        assert (part - ref).abs().max().item() <= tol * denom, f"d{'qkv'[i]}"
    for i, n in enumerate(lengths):  # dk = dv = 0 past the length, written into torch.empty
        assert not got[i, n:, c:].any()


@pytest.mark.cuda
def test_autograd_function_launches_k1_with_lse_and_k2(cuda_device):
    """Grad wanted: K1 with lse, then K2 on backward (a non-contiguous
    upstream gradient is made contiguous); inference: K1 alone, once."""
    qkv, cos, sin, lens = make_inputs(3, 12, 64, 96, (96, 40), cuda_device, torch.bfloat16)
    x = qkv.clone().requires_grad_(True)
    ra.reset_launches()
    out = ra.qkv_rope_attention(x, cos, sin, lens, 0.125, 12)
    g = torch.randn(out.shape[::-1], device=cuda_device).to(out.dtype).permute(2, 1, 0)
    (dx,) = torch.autograd.grad(out, x, g)
    torch.cuda.synchronize()
    assert (ra.launches, ra.bwd_launches) == (1, 1)
    o, lse = ra.rope_attention_fwd(qkv, cos, sin, lens, 0.125, 12, with_lse=True)
    assert torch.equal(dx, ra.rope_attention_bwd(qkv, g.contiguous(), o, lse, cos, sin, lens, 0.125, 12))
    ra.reset_launches()
    with torch.inference_mode():
        ra.qkv_rope_attention(x, cos, sin, lens, 0.125, 12)
    assert (ra.launches, ra.bwd_launches) == (1, 0)


PADDED16 = (256, 256, 200, 130, 64, 1, 255, 129, 256, 256, 224, 180, 256, 33, 2, 256)
STRIDED_SHAPES = [
    (16, 72, 1024, (1024,) * 4),  # DiT-XL/2 512^2 (16 rows with CFG there)
    (16, 72, 1024, (1024, 700, 513, 1)),
    (12, 64, 256, PADDED16),
    (2, 16, 40, (40, 33, 17)),  # T not a multiple of 64
    (2, 128, 128, (128, 70)),
    (4, 40, 64, (64, 5)),
]


def assert_valid_rows_close(got, want, lengths, atol, rows_axis=1):
    for i, n in enumerate(lengths):
        g, w = got[i].float(), want[i].float()
        if rows_axis == 2:  # (H, T, d)
            g, w = g[:, :n], w[:, :n]
        else:
            g, w = g[:n], w[:n]
        err = (g - w).abs().max().item()
        assert err <= atol, f"row {i} (length {n}): max abs err {err} > {atol}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("h,d,t,lengths", STRIDED_SHAPES)
def test_masked_attention_kernel_matches_plain_version(cuda_device, dtype, atol, h, d, t, lengths):
    """K1 with RoPE off on (B, H, T, d) views of a packed projection, as
    SelfAttention(use_rope=False) feeds it."""
    qkv, _, _, lens = make_inputs(4, h, d, t, lengths, cuda_device, dtype)
    q, k, v = qkv.view(len(lengths), t, 3, h, d).transpose(1, 3).unbind(2)
    ra.reset_launches()
    attn.reset_launches()
    got = attn.masked_attention(q, k, v, lengths=lens)
    torch.cuda.synchronize()
    assert (attn.launches, ra.launches, ra.flash_launches) == (1, 0, 0)
    assert got.dtype == dtype and got.shape == q.shape and got.transpose(1, 2).is_contiguous()
    want = attn.masked_attention_reference(q.float(), k.float(), v.float(), lens, d**-0.5)
    assert torch.isfinite(got).all()
    assert_valid_rows_close(got, want, lengths, atol, rows_axis=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("packed", [False, True], ids=["contiguous", "projection-views"])
@pytest.mark.parametrize("h,d,t,lengths", [(16, 72, 256, PADDED16), (16, 72, 256, (256,) * 16), (2, 16, 40, (40, 7))])
def test_rope_flash_attention_kernel_matches_plain_version(cuda_device, dtype, atol, packed, h, d, t, lengths):
    """K1 with RoPE on (B, T, H, d) operands: contiguous tensors, and views
    of a (B, T, 3, H, d) projection."""
    qkv, cos, sin, lens = make_inputs(5, h, d, t, lengths, cuda_device, dtype)
    b = len(lengths)
    if packed:
        q, k, v = qkv.view(b, t, 3, h, d).unbind(2)
    else:
        q, k, v = (x.contiguous() for x in qkv.view(b, t, 3, h, d).unbind(2))
    ra.reset_launches()
    got = ra.rope_flash_attention(q, k, v, cos, sin, lens, d**-0.5)
    torch.cuda.synchronize()
    assert (ra.flash_launches, ra.launches) == (1, 0)
    assert got.dtype == dtype and got.shape == (b, t, h, d)
    want = ra.rope_flash_reference(q.float(), k.float(), v.float(), cos, sin, lens, d**-0.5)
    assert_valid_rows_close(got, want, lengths, atol)
    # the same numbers as the packed entry: one kernel reads both layouts
    packed_out = ra.qkv_rope_attention(qkv, cos, sin, lens, d**-0.5, h).view(b, t, h, d)
    assert_valid_rows_close(got, packed_out, lengths, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_gradients_through_the_strided_entries(cuda_device, dtype):
    """masked_attention: K1 forward, then the PyTorch recompute backward;
    rope_flash_attention: stacked into the packed autograd Function (K1 with
    lse, then K2), against K2's plain version, at K2's tolerances."""
    h, d, t, lengths = 12, 64, 96, (96, 50, 1)
    qkv, cos, sin, lens = make_inputs(6, h, d, t, lengths, cuda_device, dtype)
    b = len(lengths)
    g = torch.randn((b, t, h, d), generator=torch.Generator(cuda_device).manual_seed(2), device=cuda_device).to(dtype)
    views = [x.clone().requires_grad_(True) for x in qkv.view(b, t, 3, h, d).unbind(2)]
    ra.reset_launches()
    attn.reset_launches()
    out = attn.masked_attention(*(x.transpose(1, 2) for x in views), lengths=lens)
    grads = torch.autograd.grad(out, views, g.transpose(1, 2))
    want = attn.masked_attention_backward_reference(
        *(x.detach().transpose(1, 2) for x in views), g.transpose(1, 2), lens, d**-0.5
    )
    for got_x, want_x in zip(grads, want):
        assert_grad_close(got_x, want_x.transpose(1, 2), dtype)
    out = ra.rope_flash_attention(*views, cos, sin, lens, d**-0.5)
    grads = torch.autograd.grad(out, views, g)
    torch.cuda.synchronize()
    assert (attn.launches, ra.launches, ra.bwd_launches, ra.flash_launches) == (1, 1, 1, 0)
    o, lse = ra.rope_attention_fwd(qkv, cos, sin, lens, d**-0.5, h, with_lse=True)
    want = ra.rope_attention_backward_reference(qkv, g.reshape(b, t, h * d), o, lse, cos, sin, lens, d**-0.5, h)
    want = want.view(b, t, 3, h, d).unbind(2)
    for got_x, want_x in zip(grads, want):
        assert_grad_close(got_x, want_x, dtype)


def assert_grad_close(got, want, dtype):
    """K2's bar: max abs error over max |plain| (bf16) or over max(1, max |plain|) (fp32)."""
    ref = want.float()
    denom = ref.abs().max().item() if dtype == torch.bfloat16 else max(1.0, ref.abs().max().item())
    assert (got.float() - ref).abs().max().item() <= GRAD_REL[dtype] * denom


@pytest.mark.cuda
def test_strided_entries_reject_bad_views(cuda_device):
    qkv, cos, sin, lens = make_inputs(7, 2, 16, 16, (16, 16), cuda_device, torch.float32)
    wide = torch.zeros((2, 16, 3 * 32 + 4), device=cuda_device)[..., : 3 * 32]  # token stride 100
    q, k, v = wide.unflatten(-1, (3, 2, 16)).unbind(2)
    ra.reset_launches()
    with pytest.raises(ValueError, match="multiples of 8"):
        ra.rope_flash_attention(q, k, v, cos, sin, lens, 0.25)
    with pytest.raises(ValueError, match="multiples of 8"):
        attn.masked_attention(*(x.transpose(1, 2) for x in (q, k, v)), lengths=lens)
    assert ra.flash_launches == 0


# The bf16 K1 (the mma.sync kernel) over its whole contract, through the C
# entry's wrapper: the operands as views of the packed (B, T, 3C) projection,
# contiguous (B, T, H, d) tensors, or contiguous (B, H, T, d) tensors read
# through their transpose (the output in the same layout); RoPE on and off;
# lse on and off; every compiled padding (d = 72 pads to 80); and T from 1
# to 4096, each batch holding a full row, a padded one and a one-key row.
K1_LAYOUTS = ["packed", "bthd", "bhtd"]
K1_T_LENGTHS = [(1, (1, 1)), (96, (96, 50, 1)), (256, (256, 131, 1)), (4096, (4096, 1000, 1))]


def k1_operands(layout, h, d, t, lengths, device, seed, dtype=torch.bfloat16):
    """(B, T, H, d) q, k, v and an empty output in ``layout``, with cos,
    sin and lengths."""
    qkv, cos, sin, lens = make_inputs(seed, h, d, t, lengths, device, dtype)
    b = len(lengths)
    q, k, v = qkv.view(b, t, 3, h, d).unbind(2)
    if layout == "packed":
        out = torch.empty((b, t, h * d), dtype=qkv.dtype, device=device).view(b, t, h, d)
    elif layout == "bthd":
        q, k, v = (x.contiguous() for x in (q, k, v))
        out = torch.empty_like(q)
    else:
        q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
        out = torch.empty_like(q)  # keeps q's (B, H, T, d) memory order
    return q, k, v, out, cos, sin, lens


def k1_plain(q, k, v, cos, sin, lens, scale, with_lse):
    qf, kf = (ra._rope_heads(x, cos, sin) if cos is not None else x.float() for x in (q, k))
    return ra._softmax_attention(qf, kf, v.float(), lens, scale, with_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("t,lengths", K1_T_LENGTHS, ids=[f"T{t}" for t, _ in K1_T_LENGTHS])
@pytest.mark.parametrize("d", [16, 32, 64, 72, 128])
@pytest.mark.parametrize("with_lse", [False, True], ids=["no-lse", "lse"])
@pytest.mark.parametrize("rope", [False, True], ids=["rope-off", "rope-on"])
@pytest.mark.parametrize("layout", K1_LAYOUTS)
def test_bf16_k1_matches_plain_version(cuda_device, layout, rope, with_lse, d, t, lengths):
    h = 2 if t == 4096 else 4
    q, k, v, out, cos, sin, lens = k1_operands(layout, h, d, t, lengths, cuda_device, seed=d + t)
    if not rope:
        cos = sin = None
    b = len(lengths)
    lse = torch.empty((b, t, h), dtype=torch.float32, device=cuda_device) if with_lse else None
    ra._k1_launch(q, k, v, out, cos, sin, lens, d**-0.5 * ra.LOG2_E, lse)
    torch.cuda.synchronize()
    want, lse_want = k1_plain(q, k, v, cos, sin, lens, d**-0.5, with_lse)
    assert torch.isfinite(out).all()
    assert_valid_rows_close(out, want, lengths, 3e-2)
    if with_lse:
        assert torch.isfinite(lse).all()
        tol = GRAD_REL[torch.bfloat16] * max(1.0, lse_want.abs().max().item())
        assert (lse - lse_want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("layout", K1_LAYOUTS)
@pytest.mark.parametrize("rope", [False, True], ids=["rope-off", "rope-on"])
def test_bf16_k1_launches_repeat_bit_for_bit(cuda_device, layout, rope):
    h, d, t, lengths = 16, 72, 1024, (1024, 700, 1)
    q, k, v, out, cos, sin, lens = k1_operands(layout, h, d, t, lengths, cuda_device, seed=11)
    if not rope:
        cos = sin = None
    lse = torch.empty((len(lengths), t, h), dtype=torch.float32, device=cuda_device)
    out2, lse2 = torch.empty_like(out), torch.empty_like(lse)
    ra._k1_launch(q, k, v, out, cos, sin, lens, d**-0.5 * ra.LOG2_E, lse)
    ra._k1_launch(q, k, v, out2, cos, sin, lens, d**-0.5 * ra.LOG2_E, lse2)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "h,d,t,lengths",
    [
        (12, 64, 256, (256, 200, 130, 64, 1, 255, 129, 33)),  # FiT-B/2 training
        (16, 72, 4096, (4000,)),  # XL at 1024^2: the last key tile holds 32 keys
        (16, 72, 2304, (2304, 1500)),  # XL at 768^2
        (2, 128, 96, (96, 1)),
    ],
)
def test_k2_from_the_bf16_k1_lse_matches_autograd(cuda_device, h, d, t, lengths):
    """K2 fed by the bf16 K1's out and lse against the exact VJP (autograd
    through the fp32 plain forward): dq, dk and dv each within 3e-2 of max
    |plain|."""
    qkv, cos, sin, lens = make_inputs(12, h, d, t, lengths, cuda_device, torch.bfloat16)
    g = torch.randn((len(lengths), t, h * d), generator=torch.Generator(cuda_device).manual_seed(3), device=cuda_device)
    out, lse = ra.rope_attention_fwd(qkv, cos, sin, lens, d**-0.5, h, with_lse=True)
    got = ra.rope_attention_bwd(qkv, g.bfloat16(), out, lse, cos, sin, lens, d**-0.5, h).float()
    x = qkv.float().requires_grad_(True)
    (want,) = torch.autograd.grad(ra.rope_attention_reference(x, cos, sin, lens, d**-0.5, h), x, g.bfloat16().float())
    c = h * d
    for i in range(3):
        part, ref = got[..., i * c : (i + 1) * c], want[..., i * c : (i + 1) * c]
        assert (part - ref).abs().max().item() <= GRAD_REL[torch.bfloat16] * ref.abs().max().item(), f"d{'qkv'[i]}"


# The fp32 K1 (the 3xTF32 mma.sync kernel) over its whole contract, as the
# bf16 one above: every layout, RoPE on and off, lse on and off, every
# compiled padding and T from 1 to 1024 (a one-key row, a ragged last tile
# and a full row in each batch), at the fp32 bar.
FP32_K1_T_LENGTHS = [(1, (1, 1)), (96, (96, 50, 1)), (256, (256, 131, 1)), (1024, (1024, 700, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("t,lengths", FP32_K1_T_LENGTHS, ids=[f"T{t}" for t, _ in FP32_K1_T_LENGTHS])
@pytest.mark.parametrize("d", [16, 32, 64, 72, 128])
@pytest.mark.parametrize("with_lse", [False, True], ids=["no-lse", "lse"])
@pytest.mark.parametrize("rope", [False, True], ids=["rope-off", "rope-on"])
@pytest.mark.parametrize("layout", K1_LAYOUTS)
def test_fp32_k1_matches_plain_version(cuda_device, layout, rope, with_lse, d, t, lengths):
    h = 4
    q, k, v, out, cos, sin, lens = k1_operands(layout, h, d, t, lengths, cuda_device, seed=d + t, dtype=torch.float32)
    if not rope:
        cos = sin = None
    lse = torch.empty((len(lengths), t, h), dtype=torch.float32, device=cuda_device) if with_lse else None
    ra._k1_launch(q, k, v, out, cos, sin, lens, d**-0.5 * ra.LOG2_E, lse)
    torch.cuda.synchronize()
    want, lse_want = k1_plain(q, k, v, cos, sin, lens, d**-0.5, with_lse)
    assert torch.isfinite(out).all()
    assert_valid_rows_close(out, want, lengths, 1e-4)
    if with_lse:
        assert torch.isfinite(lse).all()
        tol = GRAD_REL[torch.float32] * max(1.0, lse_want.abs().max().item())
        assert (lse - lse_want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("layout", K1_LAYOUTS)
@pytest.mark.parametrize("rope", [False, True], ids=["rope-off", "rope-on"])
def test_fp32_k1_launches_repeat_bit_for_bit(cuda_device, layout, rope):
    h, d, t, lengths = 16, 72, 1024, (1024, 700, 1)
    q, k, v, out, cos, sin, lens = k1_operands(layout, h, d, t, lengths, cuda_device, seed=13, dtype=torch.float32)
    if not rope:
        cos = sin = None
    lse = torch.empty((len(lengths), t, h), dtype=torch.float32, device=cuda_device)
    out2, lse2 = torch.empty_like(out), torch.empty_like(lse)
    ra._k1_launch(q, k, v, out, cos, sin, lens, d**-0.5 * ra.LOG2_E, lse)
    ra._k1_launch(q, k, v, out2, cos, sin, lens, d**-0.5 * ra.LOG2_E, lse2)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "h,d,t,lengths",
    [
        (12, 64, 256, (256, 200, 130, 64, 1, 255, 129, 33)),  # FiT-B/2 training
        (16, 72, 1024, (1024, 700, 1)),
        (2, 128, 96, (96, 1)),
    ],
)
def test_k2_from_the_fp32_k1_lse_matches_autograd(cuda_device, h, d, t, lengths):
    """The fp32 K2 (3xTF32 passes) fed by the 3xTF32 K1's out and lse against
    the exact VJP (autograd through the fp32 plain forward): dq, dk and dv
    each within 1e-4 of max(1, max |plain|), K2's fp32 bar."""
    qkv, cos, sin, lens = make_inputs(14, h, d, t, lengths, cuda_device, torch.float32)
    g = torch.randn((len(lengths), t, h * d), generator=torch.Generator(cuda_device).manual_seed(5), device=cuda_device)
    out, lse = ra.rope_attention_fwd(qkv, cos, sin, lens, d**-0.5, h, with_lse=True)
    got = ra.rope_attention_bwd(qkv, g, out, lse, cos, sin, lens, d**-0.5, h)
    x = qkv.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(ra.rope_attention_reference(x, cos, sin, lens, d**-0.5, h), x, g)
    c = h * d
    for i in range(3):
        part, ref = got[..., i * c : (i + 1) * c], want[..., i * c : (i + 1) * c]
        assert (part - ref).abs().max().item() <= GRAD_REL[torch.float32] * max(1.0, ref.abs().max().item()), f"d{'qkv'[i]}"


# K2 (the prologue and the two mma.sync passes, bf16 and fp32) over its
# range: every compiled padding (d = 72 pads to 80) and T from 1 to 4096,
# each batch holding a full row, one whose last key tile is partial and a
# one-key row.
K2_T_LENGTHS = [
    (1, (1, 1)),
    (32, (32, 17, 1)),
    (96, (96, 50, 1)),
    (256, (256, 131, 1)),
    (1024, (1024, 700, 1)),
    (2304, (2304, 1500, 1)),
    (4096, (4096, 4000, 1)),
]


K2_DTYPES = [torch.bfloat16, torch.float32]


def k2_case(h, d, t, lengths, device, seed, dtype=torch.bfloat16):
    """Inputs of K2 in ``dtype`` with K1's out and lse, and the plain version's dqkv."""
    qkv, cos, sin, lens = make_inputs(seed, h, d, t, lengths, device, dtype)
    gen = torch.Generator(device).manual_seed(seed)
    g = torch.randn((len(lengths), t, h * d), generator=gen, device=device).to(dtype)
    out, lse = ra.rope_attention_fwd(qkv, cos, sin, lens, d**-0.5, h, with_lse=True)
    want = ra.rope_attention_backward_reference(qkv, g, out, lse, cos, sin, lens, d**-0.5, h).float()
    return (qkv, g, out, lse, cos, sin, lens, d**-0.5, h), want


@pytest.mark.cuda
@pytest.mark.parametrize("t,lengths", K2_T_LENGTHS, ids=[f"T{t}" for t, _ in K2_T_LENGTHS])
@pytest.mark.parametrize("d", [16, 32, 64, 72, 128])
@pytest.mark.parametrize("dtype", K2_DTYPES, ids=["bf16", "fp32"])
def test_k2_matches_plain_version(cuda_device, dtype, d, t, lengths):
    """bf16: dq, dk and dv each within 3e-2 of max |plain|; at T 1 every
    row has one key, so the exact dq and dk are 0 (a softmax over one key
    has no gradient in its score) and rounding is all there is: they are
    held to 3e-2 of max |plain dv|, the gradient's scale. fp32: each within
    1e-4 of max(1, max |plain|). Keys at or past a row's length get exactly
    0, though the output comes from torch.empty over memory just filled
    with NaN."""
    h = 2 if t >= 1024 else 4
    args, want = k2_case(h, d, t, lengths, cuda_device, seed=d + t, dtype=dtype)
    torch.full_like(args[0], float("nan"))  # freed at once: the caching allocator gives K2's output this block
    ra.reset_launches()
    got = ra.rope_attention_bwd(*args).float()
    torch.cuda.synchronize()
    assert ra.bwd_launches == 1 and torch.isfinite(got).all()
    c = h * d
    dv_scale = want[..., 2 * c :].abs().max().item()
    for i in range(3):
        part, ref = got[..., i * c : (i + 1) * c], want[..., i * c : (i + 1) * c]
        if dtype == torch.bfloat16:
            bar = 3e-2 * (dv_scale if t == 1 and i < 2 else ref.abs().max().item())
        else:
            bar = GRAD_REL[torch.float32] * max(1.0, ref.abs().max().item())
        assert (part - ref).abs().max().item() <= bar, f"d{'qkv'[i]}"
    for i, n in enumerate(lengths):
        assert not got[i, n:, c:].any()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "h,d,t,lengths",
    [
        (12, 64, 256, (256, 200, 130, 64, 1, 255, 129, 33) * 8),  # the FiT-B/2 micro-batch
        (16, 72, 1024, (1024, 700, 1, 1000)),  # XL at 512^2
    ],
    ids=["B2-T256", "XL-T1024"],
)
@pytest.mark.parametrize("dtype", K2_DTYPES, ids=["bf16", "fp32"])
def test_k2_launches_repeat_bit_for_bit(cuda_device, dtype, h, d, t, lengths):
    """No atomics: two K2 calls on the same inputs write the same bits."""
    args, _ = k2_case(h, d, t, lengths, cuda_device, seed=13, dtype=dtype)
    first = ra.rope_attention_bwd(*args)
    second = ra.rope_attention_bwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", K2_DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("h,d,t,lengths", [(12, 64, 256, (256, 200, 130, 64, 1, 255, 129, 33) * 8),
                                           (2, 72, 2304, (2304, 1500, 1))], ids=["B2-T256", "XL-T2304"])
def test_k2_passes_one_by_one_give_a_whole_call(cuda_device, dtype, h, d, t, lengths):
    """The prologue, the dk/dv pass and the dq pass launched one at a time
    (each reading what the earlier ones wrote into the scratch) write the
    bits of one whole call."""
    args, _ = k2_case(h, d, t, lengths, cuda_device, seed=17, dtype=dtype)
    whole = ra.rope_attention_bwd(*args)
    by_pass, scratch = torch.empty_like(args[0]), ra._k2_scratch(args[0], h)
    for bit in (1, 2, 4):
        ra._k2_launch(*args, by_pass, *scratch, passes=bit)
    torch.cuda.synchronize()
    assert torch.equal(by_pass, whole)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in bf16 ulps of want; values under 2^-8 in
    magnitude are judged at the ulp of 2^-8."""
    want = want.float()
    exp = torch.floor(torch.log2(want.abs().clamp_min(2.0**-8)))
    return ((got.float() - want).abs() / torch.exp2(exp - 7)).max().item()


def row_inputs(kind, b, t, width, device, dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, t, width), generator=gen, device=device) * 3 + 1
    if kind == "adaln":  # shift and scale: chunks of a (B, 6D) adaLN output
        mod = torch.randn((b, 6 * width), generator=gen, device=device).to(dtype)
        return x.to(dtype), mod[:, :width], mod[:, width : 2 * width]
    return x.to(dtype), torch.randn((b, t, width), generator=gen, device=device).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("with_quant", [True, False], ids=["int8", "no-quant"])
@pytest.mark.parametrize(
    "kind,b,t,width",
    [
        ("adaln", 16, 256, 1152),  # XL, batch 8 with CFG
        ("adaln", 3, 33, 1152),  # ragged row count: T no multiple of the 4 rows a block takes
        ("adaln", 2, 5, 8),  # one chunk a row; on K3's warp, 2 lanes of 32
        ("adaln", 1, 3, 8192),  # the widest row: 8 chunks a thread
        ("adaln", 1, 1, 1152),  # one row; the widest K3's warp takes (9 quads a lane)
        ("adaln", 2, 7, 384),  # S: 3 quads a lane
        ("adaln", 3, 6, 768),  # B: 6 quads a lane; the last block of each batch row half full
        ("adaln", 2, 9, 1024),  # L: 8 quads a lane
        ("adaln", 2, 3, 1160),  # one chunk past the widest row K3's warp takes: a block per row
        ("adaln", 64, 256, 1152),  # batch 32 with CFG: each warp walks several rows
        ("adaln", 40, 251, 1152),  # several rows a warp, and T no multiple of the rows a block takes
        ("silu", 16, 256, 3072),  # XL SwiGLU hidden
        ("silu", 3, 33, 3072),
        ("silu", 2, 7, 2048),  # FiT-B's hidden
    ],
)
def test_row_kernels_match_plain_versions(cuda_device, kind, b, t, width, with_quant, dtype):
    args = row_inputs(kind, b, t, width, cuda_device, dtype)
    quant.reset_launches()
    fused_adaln.reset_launches()
    if kind == "adaln":
        got = quant.adaln_quant(*args) if with_quant else fused_adaln.adaln_modulate(*args)
        want = quant.adaln_quant(*args, plain=True) if with_quant else fused_adaln.adaln_modulate(*args, plain=True)
        name = "adaln_quant" if with_quant else "adaln_modulate"
    else:
        got = quant.silu_mul_quant(*args) if with_quant else fused_adaln.swiglu_glue(*args)
        want = quant.silu_mul_quant(*args, plain=True) if with_quant else fused_adaln.swiglu_glue(*args, plain=True)
        name = "silu_mul_quant" if with_quant else "swiglu_glue"
    torch.cuda.synchronize()
    counts = {**quant.launches, **fused_adaln.launches}
    assert counts == {k: int(k == name) for k in counts}
    if with_quant:
        (q, s), (q_ref, s_ref) = got, want
        assert q.dtype == torch.int8 and q.shape == (b, t, width)
        assert s.dtype == torch.float32 and s.shape == (b, t, 1)
        diff = (q.int() - q_ref.int()).abs()
        assert diff.max().item() <= 1
        assert (diff > 0).sum().item() <= 1e-3 * diff.numel() + 1
        torch.testing.assert_close(s, s_ref, rtol=1e-6, atol=0)
    else:
        assert got.dtype == dtype and got.shape == (b, t, width)
        if dtype == torch.bfloat16:
            assert bf16_ulps(got, want) <= 1
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,dtype", [(16, 256, torch.bfloat16), (40, 251, torch.float32)], ids=["bf16", "fp32"])
def test_adaln_quant_launches_repeat_bit_for_bit(cuda_device, b, t, dtype):
    """Two launches of K3 on the same inputs give identical codes and scales:
    each row's sums run in a fixed order, whichever warp takes the row."""
    args = row_inputs("adaln", b, t, 1152, cuda_device, dtype, seed=5)
    q1, s1 = quant.adaln_quant(*args)
    q2, s2 = quant.adaln_quant(*args)
    torch.cuda.synchronize()
    assert torch.equal(q1, q2)
    assert torch.equal(s1.view(torch.int32), s2.view(torch.int32))


@pytest.mark.cuda
def test_row_kernels_reject_bad_arguments(cuda_device):
    x, shift, scale = row_inputs("adaln", 2, 4, 64, cuda_device, torch.float32)
    quant.reset_launches()
    with pytest.raises(ValueError, match="multiple of 8"):
        quant.adaln_quant(x[..., :60].contiguous(), shift[:, :60], scale[:, :60])
    with pytest.raises(ValueError, match="contiguous"):
        quant.adaln_quant(x.transpose(0, 1).contiguous().transpose(0, 1), shift, scale)
    with pytest.raises(TypeError):
        quant.adaln_quant(x, shift.bfloat16(), scale)
    with pytest.raises(TypeError):
        quant.silu_mul_quant(x.half(), x.half())
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(2 * 4 * 64 + 1, device=cuda_device)
        quant.silu_mul_quant(flat[1:].view(2, 4, 64), x)
    assert quant.launches == {"adaln_quant": 0, "silu_mul_quant": 0}


@pytest.mark.cuda
def test_int8_matmul_on_the_card(cuda_device):
    """torch._int_mm at a serving shape and below its 17-row minimum (padded)."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    w = torch.randint(-127, 128, (3456, 1152), generator=gen, device=cuda_device, dtype=torch.int8)
    for rows in (4096, 5):
        xq = torch.randint(-127, 128, (rows, 1152), generator=gen, device=cuda_device, dtype=torch.int8)
        acc = quant._int_mm(xq, w.t())
        want = (xq.double() @ w.double().t()).to(torch.int32)  # exact: |sums| < 2^53
        assert acc.dtype == torch.int32 and torch.equal(acc, want)


@pytest.mark.cuda
def test_dpm_sampling_through_the_kernels_matches_plain(cuda_device):
    """DPM-Solver++ sampling of a FiT at XL width (1152, 16 heads, d 72),
    depth 2, bf16, 256^2 with CFG: through K1 against the same run through
    its plain version, on the same noise, within the guided forward's 5e-2
    relative RMS; every forward of the kernel run launches K1."""
    from fit_tpu_torch.models.fit import FiT
    from fit_tpu_torch.sampling import FiTSampler

    gen = torch.Generator(cuda_device).manual_seed(0)
    model = FiT(hidden_size=1152, depth=2, num_heads=16, dtype=torch.bfloat16, device=cuda_device)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    sampler = FiTSampler(model, num_sampling_steps=4, sampler="dpm", device=cuda_device)
    z = torch.randn((2, 4, 32, 32), generator=gen, device=cuda_device)
    ra.reset_launches()
    got = sampler.sample([1, 2], 256, 256, z=z)
    assert ra.launches == 2 * 4
    model.plain_kernels = True
    want = sampler.sample([1, 2], 256, 256, z=z)
    assert torch.isfinite(got).all()
    rel = ((got - want).pow(2).mean() / want.pow(2).mean()).sqrt().item()
    assert rel <= 5e-2, rel


def _vae_pair(blocks, seed=0):
    from fit_tpu_torch.vae import AutoencoderKL

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        cpu = AutoencoderKL(blocks, device="cpu")  # PyTorch's default conv and linear init
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        out[dtype] = AutoencoderKL(blocks, dtype=dtype, device="cuda")
        out[dtype].load_state_dict(cpu.state_dict())
    return cpu, out


def _rel_rms(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).pow(2).mean() / want.pow(2).mean()).sqrt().item()


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [(8, 16, 16, 16), (128, 256, 512, 512)], ids=["small", "sd"])
def test_vae_on_the_card(cuda_device, blocks):
    """The SD VAE on the card (cuDNN convolutions, TF32 off): fp32 within
    1e-5 relative RMS of the same module on the CPU (another summation
    order), bf16 within 5e-2 of fp32 (the guided bf16 forwards' bar), for
    decode and encode_mode."""
    cpu, card = _vae_pair(blocks)
    gen = torch.Generator().manual_seed(1)
    z = torch.randn(2, 4, 8, 12, generator=gen)
    x = torch.rand(2, 3, 64, 96, generator=gen) * 2 - 1
    with torch.inference_mode():
        want_dec, want_enc = cpu.decode(z), cpu.encode_mode(x)
        dec = {d: v.decode(z.to(cuda_device)) for d, v in card.items()}
        enc = {d: v.encode_mode(x.to(cuda_device)) for d, v in card.items()}
    assert dec[torch.bfloat16].dtype == torch.bfloat16 and tuple(dec[torch.float32].shape) == (2, 3, 64, 96)
    assert _rel_rms(dec[torch.float32], want_dec) <= 1e-5 and _rel_rms(enc[torch.float32], want_enc) <= 1e-5
    assert _rel_rms(dec[torch.bfloat16], dec[torch.float32]) <= 5e-2
    assert _rel_rms(enc[torch.bfloat16], enc[torch.float32]) <= 5e-2


@pytest.fixture(scope="module")
def seeded_inception():
    """chip_smoke.py phase 10's seeded full-width InceptionV3, on the CPU."""
    import chip_smoke
    from fit_tpu_torch.eval.inception import convert_torch_inception

    return convert_torch_inception(chip_smoke.seeded_inception_state())


@pytest.mark.cuda
@pytest.mark.parametrize("side", [256, 512])
@pytest.mark.parametrize("variant", ["fid", "torchvision"])
def test_inception_on_the_card_matches_cpu(cuda_device, seeded_inception, variant, side):
    """InceptionV3 on the card (cuDNN, fp32 with TF32 off) against the same
    module on the CPU: pool3, spatial and probs within 1e-4 of max |CPU|,
    from an upscaled (256^2) and a downscaled, antialiased (512^2) input."""
    from fit_tpu_torch.eval.inception import make_suite_extractor

    x = np.random.default_rng(side).uniform(size=(4, 3, side, side)).astype(np.float32)
    want = make_suite_extractor(seeded_inception, variant, spatial=True, probs=True, device="cpu")(x)
    got = make_suite_extractor(seeded_inception, variant, spatial=True, probs=True, device=cuda_device)(x)
    assert set(got) == {"pool3", "spatial", "probs"}
    for k in want:
        assert got[k].shape == want[k].shape
        assert np.abs(got[k] - want[k]).max() <= 1e-4 * np.abs(want[k]).max(), k


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["pad", "bucket"])
def test_native_loader_bytes_on_the_card_host(cuda_device, tmp_path, mode):
    """The native packer built on the card's host (its own CPU flags) gives
    the numpy path's bytes, and a batch moves to the card whole."""
    from fit_tpu_torch.data import native
    from fit_tpu_torch.data.dataset import LatentFolderDataset, LatentLoader

    rng = np.random.default_rng(0)
    for i in range(24):
        (tmp_path / f"c{i % 2}").mkdir(exist_ok=True)
        lat = rng.normal(size=[(4, 32, 32), (4, 28, 36)][i % 2]).astype(np.float16)
        np.save(tmp_path / f"c{i % 2}" / f"{i}.npy", lat)
    ds = LatentFolderDataset(str(tmp_path))
    assert native.get_lib()._name == str(native.library_path())
    fast, slow = (LatentLoader(ds, 8, mode=mode, seed=1, native=n) for n in (True, False))
    for a, b in zip(fast.epoch_batches(0), slow.epoch_batches(0), strict=True):
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        assert torch.equal(torch.from_numpy(a["tokens"]).to(cuda_device).cpu(), torch.from_numpy(b["tokens"]))
