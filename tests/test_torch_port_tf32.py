"""Why the fp32 K1 and K2 take three TF32 products per product (3xTF32).

The fp32 K1 (``fit_tpu_torch/ops/csrc/rope_attention_tf32.cuh``) and the
fp32 K2 (``rope_attention_bwd_tf32.cuh``) run every product on TF32 tensor
cores. This file emulates that arithmetic in plain PyTorch on the CPU and
pins the design's accuracy argument:

- ``cvt.rna.tf32.f32`` rounds an fp32 value to 10 mantissa bits, to
  nearest with ties away from zero (:func:`tf32`);
- one TF32 product per dot (``tf32(a) @ tf32(b)``) moves the attention
  output by 7.9-8.5e-4 here against a float64 reference, past the 1e-4
  bar that the fp32 kernel is held to against its plain version;
- three products (``a = hi + lo`` with ``hi = tf32(a)``, ``lo = tf32(a - hi)``,
  and ``lo_a hi_b + hi_a lo_b + hi_a hi_b``) move it by 2.4-2.7e-7, within
  1e-5 and near fp32's own error.

The attention is K1's: RoPE-rotated q scaled by scale * log2(e), scores
over the keys below each row's length, softmax in the exp2 domain, P as
fp32 into the second product; inputs seeded with numpy as in
``test_torch_port_attention.py``, at the contract size (hidden 96, 6 heads,
d 16, T 64) and at FiT-XL's d 72. Valid query rows only.

The backward is K2's seven products (S^T, dv, dP^T, dk in the dk/dv pass;
S, dP, dq in the dq pass; S and dP are the same values in both, so each is
emulated once), fed the emulated forward's output and lse2 as K2 is fed
K1's: P = exp2(S - lse2) and dS = P (dP - delta) formed in fp32 and split
as A operands after the subtraction, the lo_a lo_b term dropped from every
product. Three products hold dq, dk and dv within 1e-5 of a float64 VJP
(at most 5.2e-6 here, beside fp32's own 8.3e-6); one product misses 1e-4
on each of them. Every query row takes part, padded rows included.
"""

import numpy as np
import pytest
import torch

from fit_tpu_torch.core.pos_embed import rope_freqs_2d
from fit_tpu_torch.ops import rope_attention as ra

CASES = [
    (6, 16, 64, (64, 40, 1)),  # the contract size: hidden 96, 6 heads
    (2, 72, 256, (256, 131, 1)),  # FiT-XL's head dim, padded to 80 on the card
]
IDS = ["d16-T64", "d72-T256"]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 as ``cvt.rna.tf32.f32``: 10 mantissa bits, round to
    nearest, ties away from zero (fp32 is sign and magnitude, so adding half
    of the dropped unit to the bits rounds the magnitude), as fp32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """fp32 ``a @ b`` as the tensor cores take it: ``products`` 1 is one
    TF32 product, 3 the 3xTF32 split; the tf32 partial products are exact
    in float64 and the sum is rounded to fp32 once."""
    a_hi, b_hi = tf32(a), tf32(b)
    out = a_hi.double() @ b_hi.double()
    if products == 3:
        a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
        out = a_lo.double() @ b_hi.double() + a_hi.double() @ b_lo.double() + out
    return out.float()


def inputs(h, d, t, lengths, seed=0):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    qkv = torch.from_numpy(rng.normal(size=(b, t, 3 * h * d)).astype(np.float32))
    side = int(np.ceil(np.sqrt(t)))
    fc = torch.from_numpy(rope_freqs_2d(d, side, side)[:t].astype(np.float32))
    cos, sin = ra.split_rope_tables(fc.expand(b, t, d))
    qr, kr, v = ra._rotated_heads(qkv, cos, sin, h)  # (B, T, H, d) fp32
    heads = [x.transpose(1, 2).contiguous() for x in (qr, kr, v)]  # (B, H, T, d)
    return heads, torch.tensor(lengths)


def attention(q, k, v, lengths, products=None):
    """K1's forward: ``products`` None in float64 (the reference), else in
    fp32 with each product emulated on the tensor cores."""
    d, t = q.shape[-1], q.shape[-2]
    q_mul = d**-0.5 * ra.LOG2_E
    valid = (torch.arange(t)[None, :] < lengths[:, None])[:, None, None, :]
    if products is None:
        q, k, v = q.double(), k.double(), v.double()
        s = (q * q_mul) @ k.transpose(-1, -2)
    else:
        s = matmul(q * q_mul, k.transpose(-1, -2), products)
    s = s.masked_fill(~valid, float("-inf"))
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    out = p @ v if products is None else matmul(p, v, products)
    return out / p.sum(-1, keepdim=True)


def valid_rows_err(got, want, lengths) -> float:
    return max((got[i, :, :n].double() - want[i, :, :n]).abs().max().item() for i, n in enumerate(lengths.tolist()))


def test_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0**-10  # tf32's unit at 1.0
    x = torch.tensor([1.0, 1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2**-23, 1 + 1.5 * ulp, 3.14159265, 0.0, -2.5e-30])
    want = torch.tensor([1.0, 1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.140625, 0.0])
    got = tf32(x)
    assert torch.equal(got[:7], want)
    assert abs(got[7].item() + 2.5e-30) <= 2.5e-30 * 2**-11  # a normal value keeps 11 bits
    assert ((tf32(x).view(torch.int32) & 0x1FFF) == 0).all()
    r = torch.from_numpy(np.random.default_rng(1).normal(size=4096).astype(np.float32))
    hi = tf32(r)
    assert ((r - hi).abs() <= hi.abs() * 2.0**-11).all()  # half a unit of the 11-bit significand
    lo = tf32(r - hi)
    assert ((r.double() - hi.double() - lo.double()).abs() <= r.double().abs() * 2.0**-21).all()


@pytest.mark.parametrize("h,d,t,lengths", CASES, ids=IDS)
def test_three_tf32_products_hold_fp32_accuracy(h, d, t, lengths):
    (q, k, v), lens = inputs(h, d, t, lengths)
    want = attention(q, k, v, lens)
    err3 = valid_rows_err(attention(q, k, v, lens, products=3), want, lens)
    fp32 = valid_rows_err(ra._softmax_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), lens,
                                                d**-0.5, False)[0].transpose(1, 2), want, lens)
    assert err3 <= 1e-5, err3  # the emulation gives 2.4-2.7e-7
    assert fp32 <= 1e-5  # fp32's own error: the plain version against float64
    assert err3 <= 10 * fp32, (err3, fp32)


@pytest.mark.parametrize("h,d,t,lengths", CASES, ids=IDS)
def test_one_tf32_product_misses_the_fp32_bar(h, d, t, lengths):
    (q, k, v), lens = inputs(h, d, t, lengths)
    err1 = valid_rows_err(attention(q, k, v, lens, products=1), attention(q, k, v, lens), lens)
    assert err1 > 1e-4, err1  # the emulation gives 7.9-8.5e-4: one TF32 product cannot serve the fp32 kernel


def attention_vjp(q, k, v, g, lengths, products=None):
    """K2's VJP on rotated (B, H, T, d) heads for the upstream ``g``: (dq_r,
    dk_r, dv). ``products`` None in float64 (the reference, from a float64
    forward), 0 in plain fp32 (the plain version's formulas), else in fp32
    with each product emulated on the tensor cores and the forward's out
    and lse2 from the same products."""
    d, t = q.shape[-1], q.shape[-2]
    q_mul = d**-0.5 * ra.LOG2_E
    valid = (torch.arange(t)[None, :] < lengths[:, None])[:, None, None, :]
    if products is None:
        q, k, v, g = q.double(), k.double(), v.double(), g.double()

    def mm(a, b):
        return a @ b if not products else matmul(a, b, products)

    qs = q * q_mul
    s = mm(qs, k.transpose(-1, -2)).masked_fill(~valid, float("-inf"))
    m = s.amax(-1, keepdim=True)
    lse = m + torch.log2(torch.exp2(s - m).sum(-1, keepdim=True))
    p = torch.exp2(s - lse)
    delta = (g * mm(p, v)).sum(-1, keepdim=True)
    dv = mm(p.transpose(-1, -2), g)
    ds = p * (mm(g, v.transpose(-1, -2)) - delta)
    return mm(ds, k) * d**-0.5, mm(ds.transpose(-1, -2), qs) / ra.LOG2_E, dv


def grad_errs(h, d, t, lengths, products) -> "list[float]":
    """max |got - ref| / max(1, max |ref|) of dq, dk and dv against the
    float64 VJP, as the card tests hold the fp32 K2 against its plain version."""
    (q, k, v), lens = inputs(h, d, t, lengths)
    g = torch.from_numpy(np.random.default_rng(7).normal(size=q.shape).astype(np.float32))
    ref = attention_vjp(q, k, v, g, lens)
    got = attention_vjp(q, k, v, g, lens, products)
    return [(a.double() - r).abs().max().item() / max(1.0, r.abs().max().item()) for a, r in zip(got, ref)]


@pytest.mark.parametrize("h,d,t,lengths", CASES, ids=IDS)
def test_three_tf32_products_hold_fp32_accuracy_backward(h, d, t, lengths):
    err3 = grad_errs(h, d, t, lengths, products=3)
    fp32 = grad_errs(h, d, t, lengths, products=0)
    for name, e3, e32 in zip(("dq", "dk", "dv"), err3, fp32):
        assert e3 <= 1e-5, (name, e3)  # the emulation gives 4e-8 to 5.2e-6
        assert e3 <= 10 * e32, (name, e3, e32)  # fp32's own error: 1.1e-7 to 8.3e-6


@pytest.mark.parametrize("h,d,t,lengths", CASES, ids=IDS)
def test_one_tf32_product_misses_the_fp32_bar_backward(h, d, t, lengths):
    err1 = grad_errs(h, d, t, lengths, products=1)
    # the emulation gives dq 1.1-2.1e-3, dk 1.6-9.0e-3, dv 2.0-2.2e-4
    assert all(e > 1e-4 for e in err1), err1
