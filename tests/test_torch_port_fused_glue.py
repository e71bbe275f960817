"""The float block's fused row glue (``ops.fused_adaln`` K5, K5R, K6) and the
rule that routes a forward to it, on the CPU.

On the card a float forward that needs no backward runs its LayerNorm +
modulate stages, the attention residual and the SwiGLU product in the row
kernels; everywhere else the block keeps its eager ops. Here there is no
card, so these tests hold:
- K5R's plain version: ``x_new`` bit-equal to the eager residual
  ``x + gate * y`` (the same roundings), its modulated output within one
  bf16 ulp of ``adaln_reference(x_new)`` (fp32: 1e-6 relative), on strided
  chunks of a (B, 6D) adaLN output at D 768 and 1152;
- a FiT-S/2 forward on the CPU bit-identical to the eager composition of
  its modules, under grad and without: the route that CPU parity with
  ``fit_tpu`` relies on;
- the routing rule (:func:`fused_glue`): eager under grad, for
  ``quant="int8"``, for other dtypes and for CPU tensors.
"""

import types
from unittest import mock

import pytest
import torch
import torch.nn.functional as F

from fit_tpu_torch.core.pos_embed import rope_freqs_2d
from fit_tpu_torch.models import layers
from fit_tpu_torch.models.fit import create_fit
from fit_tpu_torch.models.layers import fused_glue, layer_norm_fp32, linear, modulate
from fit_tpu_torch.ops import fused_adaln
from fit_tpu_torch.ops.rope_attention import split_rope_tables


def bf16_ulps(got, want) -> float:
    """Largest |got - want| in bf16 ulps of want, a value under 2^-8 in
    magnitude judged at the ulp of 2^-8 (as the card tests judge K5)."""
    want = want.float()
    exp = torch.floor(torch.log2(want.abs().clamp_min(2.0**-8)))
    return ((got.float() - want).abs() / torch.exp2(exp - 7)).max().item()


def residual_inputs(b, t, d, dtype, seed=0):
    """x, y (B, T, D) and gate, shift, scale as the block passes them:
    strided chunks of one (B, 6D) adaLN output."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((b, t, d), generator=gen) * 3 + 1).to(dtype)
    y = torch.randn((b, t, d), generator=gen).to(dtype)
    mod = torch.randn((b, 6 * d), generator=gen).to(dtype)
    _, _, gate, shift, scale, _ = mod.chunk(6, dim=-1)
    return x, y, gate, shift, scale


@pytest.mark.parametrize("d", [768, 1152])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_residual_variant_keeps_the_eager_residual_bits(dtype, d):
    x, y, gate, shift, scale = residual_inputs(2, 7, d, dtype)
    assert gate.stride(0) == 6 * d and not gate.is_contiguous()
    x_new, h = fused_adaln.adaln_residual(x, y, gate, shift, scale)
    ref_x, ref_h = fused_adaln.adaln_residual_reference(x, y, gate, shift, scale)
    assert x_new.dtype == h.dtype == dtype and x_new.shape == h.shape == x.shape
    eager = x + gate[:, None, :] * y
    assert torch.equal(x_new, eager) and torch.equal(ref_x, eager)
    assert torch.equal(h, ref_h)
    want = fused_adaln.adaln_reference(eager, shift, scale)
    if dtype == torch.bfloat16:
        assert bf16_ulps(h, want) <= 1
    else:
        torch.testing.assert_close(h, want, rtol=1e-6, atol=0)


def fit_s2_inputs(dtype, seed=0):
    """A FiT-S/2 with every parameter random (the reference init's zero
    adaLN would leave the glue nothing to do), and a padded token batch."""
    gen = torch.Generator().manual_seed(seed)
    model = create_fit("FiT-S/2", device="cpu", dtype=dtype)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.05, generator=gen)
    n, side = 2, 4
    t = side * side
    x = torch.randn((n, t, model.patch_size**2 * model.in_channels), generator=gen)
    pos = torch.from_numpy(rope_freqs_2d(model.head_dim, side, side)).float().expand(n, t, model.head_dim)
    lengths = torch.tensor([t, 11], dtype=torch.int32)
    args = (x, torch.tensor([10.0, 500.0]), torch.tensor([3, 7]), pos)
    return model, args, lengths


def eager_forward(model, x, t, y, pos, lengths):
    """The FiT token forward composed from its modules with the eager glue:
    LayerNorm then modulate, each gated residual, silu(g) * v."""
    h = linear(model.x_embedder, x.to(model.dtype))
    cos, sin = split_rope_tables(pos)
    c = model.t_embedder(t, model.dtype) + model.y_embedder.table(y).to(model.dtype)
    for blk in model.blocks:
        sm, scm, gm, sf, scf, gf = linear(blk.adaLN, F.silu(c)).chunk(6, dim=-1)
        a = blk.attn(modulate(layer_norm_fp32(h), sm, scm), cos, sin, lengths, h.dtype)
        h = h + gm[:, None, :] * a
        f_in = modulate(layer_norm_fp32(h), sf, scf)
        ffn = blk.ffn
        h = h + gf[:, None, :] * ffn.fc2(F.silu(ffn.fc1_g(f_in)) * ffn.fc1_x(f_in))
    shift, scale = linear(model.final.adaLN, F.silu(c)).chunk(2, dim=-1)
    return linear(model.final.linear, modulate(layer_norm_fp32(h), shift, scale))


@pytest.mark.parametrize("grad", [True, False], ids=["grad", "no-grad"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_cpu_forward_is_the_eager_composition(dtype, grad):
    model, args, lengths = fit_s2_inputs(dtype)
    drop = torch.zeros(2, dtype=torch.int64)
    with torch.set_grad_enabled(grad):
        got = model(*args, lengths=lengths, force_drop_ids=drop)
        want = eager_forward(model, *args, lengths)
    assert got.dtype == dtype and got.requires_grad == grad
    assert torch.equal(got, want)


def test_cpu_forward_never_calls_the_fused_wrappers():
    """A CPU forward takes the eager route with grad and without: the
    fused wrappers, patched to raise, are never reached."""
    model, args, lengths = fit_s2_inputs(torch.float32, seed=1)

    def refuse(*_, **__):
        raise AssertionError("a CPU forward reached a fused row kernel wrapper")

    patched = [mock.patch.object(layers, name, refuse) for name in ("adaln_modulate", "adaln_residual", "swiglu_glue")]
    for p in patched:
        p.start()
    try:
        for grad in (True, False):
            with torch.set_grad_enabled(grad):
                model(*args, lengths=lengths, force_drop_ids=torch.zeros(2, dtype=torch.int64))
        with torch.inference_mode():
            model(*args, lengths=lengths, force_drop_ids=torch.zeros(2, dtype=torch.int64))
    finally:
        for p in patched:
            p.stop()


def card_like(dtype):
    """What ``fused_glue`` reads of an activation on the card."""
    return types.SimpleNamespace(is_cuda=True, dtype=dtype)


@pytest.mark.parametrize(
    "where,quant,dtype,grad,fused",
    [
        ("card", "none", torch.bfloat16, False, True),
        ("card", "none", torch.float32, False, True),
        ("card", "none", torch.bfloat16, True, False),  # training and remat's recompute
        ("card", "int8", torch.bfloat16, False, False),  # the int8 epilogues keep their kernels
        ("card", "none", torch.float16, False, False),  # the kernels take bf16 and fp32
        ("cpu", "none", torch.bfloat16, False, False),
        ("cpu", "none", torch.float32, True, False),
    ],
)
def test_route_is_decided_by_device_grad_quant_and_dtype(where, quant, dtype, grad, fused):
    x = card_like(dtype) if where == "card" else torch.zeros((1, 2, 8), dtype=dtype)
    with torch.set_grad_enabled(grad):
        assert fused_glue(x, quant) is fused
    with torch.inference_mode():
        assert fused_glue(x, quant) is (quant == "none" and where == "card" and dtype != torch.float16)
