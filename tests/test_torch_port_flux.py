"""fit_tpu_torch's FLUX (``models/flux.py``, ``diffusion/flow.py``, the
N-axis RoPE tables and the plain versions of K8 and K6G) against the plain
fp32 reference ``tests/plain_flux.py``, which imports nothing of the port.

All fp32 on the CPU at a tiny size: hidden 96, 3 heads of 32 (``axes_dim``
(8, 12, 12)), 2 double and 2 single blocks, 8 text tokens of width 64, a
pooled vector of 32, 16-channel latents of 8 x 8 and 8 x 12 (16 and 24
image tokens). Tolerance 3e-5, the bar of tests/test_torch_port_ditmoe.py;
the 4-step Euler latents at max(1e-4, 2e-6 of the largest magnitude), as
DDIM's there. The block's fused route (the card's, with K5, K5R, K8, K6G
and K1 writing into shared buffers) runs here with every kernel wrapper's
plain version, against the released composition of the eager route.
"""

import filecmp
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_flux as plain
from fit_tpu_torch.core.pos_embed import rope_ids_nd
from fit_tpu_torch.diffusion import flow
from fit_tpu_torch.models import flux
from fit_tpu_torch.models.flux import Flux, create_flux
from fit_tpu_torch.ops import fused_adaln, launch_counts, reset_launches
from fit_tpu_torch.ops import rope_attention as ra
from fit_tpu_torch.ops.rope_attention import split_rope_tables

CFG = dict(in_channels=64, vec_in_dim=32, context_in_dim=64, hidden_size=96, mlp_ratio=4.0, num_heads=3, depth=2,
           depth_single_blocks=2, axes_dim=(8, 12, 12), theta=10000.0, qkv_bias=True)
TXT = 8
ATOL = 3e-5
SIZES = [(8, 8), (8, 12)]
REPO = Path(__file__).resolve().parents[1]


def tiny_flux(seed=0, std=0.05):
    """Every parameter normal(0, std) from numpy's seed, the QK-norm scales
    about 1."""
    model = Flux(**CFG, device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            mean, s = (1.0, 0.1) if name.endswith(".scale") else (0.0, std)
            p.copy_(torch.from_numpy(rng.normal(mean, s, size=tuple(p.shape)).astype(np.float32)))
    return model


def weights(model):
    return {k: v.detach() for k, v in model.state_dict().items()}


def inputs(seed, h, w, n=2):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    z = draw(n, 16, h, w)
    return dict(img=flow.pack(z), img_ids=flow.img_ids(n, h, w), txt=draw(n, TXT, 64), txt_ids=flow.txt_ids(n, TXT),
                y=draw(n, 32), timesteps=torch.from_numpy(rng.uniform(size=n).astype(np.float32)))


def plain_forward(model, x):
    return plain.forward(weights(model), CFG, x["img"], x["img_ids"], x["txt"], x["txt_ids"], x["timesteps"], x["y"])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("h,w", SIZES)
def test_tiny_flux_forward_matches_the_plain_reference(seed, h, w):
    model = tiny_flux(seed)
    x = inputs(seed, h, w)
    with torch.no_grad():
        got = model(**x)
    want = plain_forward(model, x)
    assert got.shape == (2, (h // 2) * (w // 2), 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("h,w", SIZES)
def test_the_fused_route_with_plain_kernels_matches_the_eager_route(h, w, monkeypatch):
    """The card's route (joint buffer at row offsets, K8 in place in
    linear1's output, K1 and K6G writing linear2's input by column) run
    with each wrapper's plain version: the same forward, and no launch."""
    model = tiny_flux(3)
    x = inputs(3, h, w)
    with torch.no_grad():
        eager = model(**x)
        monkeypatch.setattr(flux, "fused_glue", lambda t, quant: True)
        reset_launches()
        model.plain_kernels = True
        fused = model(**x)
    assert launch_counts() == {k: 0 for k in launch_counts()}
    np.testing.assert_allclose(fused.numpy(), eager.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("h,w", SIZES)
def test_tiny_flux_euler_latents_match_the_plain_reference(h, w):
    model = tiny_flux(4)
    x = inputs(4, h, w)
    steps = plain.get_schedule(4, x["img"].shape[1], shift=False)
    assert flow.get_schedule(4, x["img"].shape[1], shift=False) == steps == [1.0, 0.75, 0.5, 0.25, 0.0]
    got = flow.denoise(model, x["img"], x["img_ids"], x["txt"], x["txt_ids"], x["y"], steps)
    with torch.no_grad():
        want = plain.denoise(weights(model), CFG, x["img"], x["img_ids"], x["txt"], x["txt_ids"], x["y"], steps)
    tol = max(1e-4, 2e-6 * want.abs().max().item())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=0)
    assert flow.unpack(got, h, w).shape == (2, 16, h, w)


@pytest.mark.parametrize("seq_len", [256, 1024, 4096])
def test_the_shifted_schedule_is_the_released_one(seq_len):
    got = flow.get_schedule(28, seq_len)
    want = plain.get_schedule(28, seq_len)
    assert got[0] == 1.0 and got[-1] == 0.0 and all(a > b for a, b in zip(got, got[1:]))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_pack_is_the_released_rearrange_and_unpack_inverts_it():
    z = torch.arange(2 * 16 * 4 * 6, dtype=torch.float32).reshape(2, 16, 4, 6)
    tokens = flow.pack(z)
    assert torch.equal(tokens, plain.pack(z))
    # token (row 1, col 2) holds channel c's 2 x 2 patch at latent rows 2..3, cols 4..5, channel slowest
    assert torch.equal(tokens[0, 1 * 3 + 2].reshape(16, 2, 2), z[0, :, 2:4, 4:6])
    assert torch.equal(flow.unpack(tokens, 4, 6), z)
    assert torch.equal(flow.img_ids(2, 4, 6), plain.image_ids(2, 4, 6))


@pytest.mark.parametrize("axes_dim", [(16, 56, 56), (8, 12, 12)])
def test_the_n_axis_tables_are_embed_nds(axes_dim):
    """``rope_ids_nd`` through ``split_rope_tables`` rotates as EmbedND's
    2 x 2 matrices do; text rows (all-zero ids) are the identity."""
    ids = torch.cat([flow.txt_ids(2, 5), flow.img_ids(2, 6, 10)], dim=1)
    table = rope_ids_nd(ids, axes_dim, 10000.0)
    d = sum(axes_dim)
    assert table.shape == (2, 5 + 15, d) and table.dtype == torch.float32
    cos, sin = split_rope_tables(table)
    x = torch.randn(2, 20, 1, d, dtype=torch.float64).float()
    got = x * cos[:, :, None] + ra.rotate_pairs(x) * sin[:, :, None]
    want, _ = plain.apply_rope(x.transpose(1, 2), x.transpose(1, 2), plain.embed_nd(ids, axes_dim, 10000.0))
    torch.testing.assert_close(got, want.transpose(1, 2), rtol=0, atol=1e-6)
    assert torch.equal(cos[:, :5], torch.ones_like(cos[:, :5])) and torch.equal(sin[:, :5], torch.zeros_like(sin[:, :5]))
    # image token 5 sits at row 1, col 0 of the 3 x 5 grid: axis 1's first pair turns by 1 at frequency 1
    assert table[0, 5 + 5, axes_dim[0]] == pytest.approx(math.cos(1.0), abs=1e-7)
    with pytest.raises(ValueError):
        rope_ids_nd(ids[..., :2], axes_dim)


def _qk_ref(x, scale, heads):
    """The RMSNorm of each head, written out."""
    b, t, c = x.shape
    xh = x.double().reshape(b, t, heads, c // heads)
    return (xh / xh.pow(2).mean(-1, keepdim=True).add(1e-6).sqrt() * scale.double()).reshape(b, t, c)


def test_qk_norm_into_a_joint_buffer_at_a_row_offset():
    """K8's plain version from a strided view into rows 3.. of a wider
    buffer: q and k normed, v copied, other rows untouched."""
    heads, d = 2, 32
    c = heads * d
    src = torch.randn(2, 5, 3 * c + 16)[..., : 3 * c]  # a row stride wider than the row
    qs, ks = torch.rand(d) + 0.5, torch.rand(d) + 0.5
    joint = torch.full((2, 9, 3 * c), 7.0)
    assert fused_adaln.qk_norm(src, qs, ks, heads, out=joint, row_offset=3) is joint
    torch.testing.assert_close(joint[:, 3:8, :c].double(), _qk_ref(src[..., :c], qs, heads), rtol=0, atol=1e-6)
    torch.testing.assert_close(joint[:, 3:8, c : 2 * c].double(), _qk_ref(src[..., c : 2 * c], ks, heads), rtol=0,
                               atol=1e-6)
    assert torch.equal(joint[:, 3:8, 2 * c :], src[..., 2 * c :])
    assert torch.all(joint[:, :3] == 7.0) and torch.all(joint[:, 8:] == 7.0)


def test_qk_norm_in_place_leaves_v_and_the_other_columns():
    heads, d = 3, 32
    c = heads * d
    h1 = torch.randn(2, 4, 7 * c)
    before = h1.clone()
    qs, ks = torch.rand(d) + 0.5, torch.rand(d) + 0.5
    assert fused_adaln.qk_norm(h1, qs, ks, heads) is h1
    torch.testing.assert_close(h1[..., :c].double(), _qk_ref(before[..., :c], qs, heads), rtol=0, atol=1e-6)
    torch.testing.assert_close(h1[..., c : 2 * c].double(), _qk_ref(before[..., c : 2 * c], ks, heads), rtol=0,
                               atol=1e-6)
    assert torch.equal(h1[..., 2 * c :], before[..., 2 * c :])
    half = h1.bfloat16()
    assert fused_adaln.qk_norm(half, qs.bfloat16(), ks.bfloat16(), heads, plain=True).dtype == torch.bfloat16


def test_gelu_glue_reads_and_writes_by_row_stride():
    h1 = torch.randn(2, 5, 96)
    cat = torch.zeros(2, 5, 80)
    out = fused_adaln.gelu_glue(h1[..., 32:], out=cat[..., 16:])
    assert out.data_ptr() == cat[..., 16:].data_ptr()
    torch.testing.assert_close(cat[..., 16:], torch.nn.functional.gelu(h1[..., 32:], approximate="tanh"), rtol=0,
                               atol=1e-6)
    assert torch.all(cat[..., :16] == 0)
    fresh = fused_adaln.gelu_glue(h1.bfloat16())
    assert fresh.is_contiguous() and fresh.dtype == torch.bfloat16
    assert torch.equal(fresh, fused_adaln.gelu_reference(h1.bfloat16()))


def test_rope_flash_attention_writes_into_out():
    b, t, h, d = 2, 6, 2, 16
    q, k, v = torch.randn(3, b, t, h, d).unbind(0)
    cos, sin = split_rope_tables(rope_ids_nd(flow.img_ids(b, 4, 6), (4, 6, 6)))
    lengths = torch.full((b,), t, dtype=torch.int32)
    buf = torch.zeros(b, t, 3 * h * d)
    out = buf[..., h * d : 2 * h * d].view(b, t, h, d)
    got = ra.rope_flash_attention(q, k, v, cos, sin, lengths, d**-0.5, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out, ra.rope_flash_attention(q, k, v, cos, sin, lengths, d**-0.5))
    assert torch.all(buf[..., : h * d] == 0) and torch.all(buf[..., 2 * h * d :] == 0)


def test_the_registry_holds_schnells_sizes_and_counts_11_9b():
    with pytest.raises(KeyError):
        create_flux("flux-dev", device="meta")
    m = create_flux("flux-schnell", device="meta")
    assert (m.hidden_size, m.num_heads, m.head_dim, m.axes_dim) == (3072, 24, 128, (16, 56, 56))
    assert (len(m.double_blocks), len(m.single_blocks)) == (19, 38)
    assert m.single_blocks[0].linear1.weight.shape == (21504, 3072)
    assert m.single_blocks[0].linear2.weight.shape == (3072, 15360)
    assert m.txt_in.weight.shape == (3072, 4096) and m.vector_in.in_layer.weight.shape == (3072, 768)
    assert m.double_blocks[0].img_attn.qkv.bias is not None
    assert sum(p.numel() for p in m.parameters()) == 11_891_178_560
    names = {n for n, _ in m.named_parameters()}
    assert {"double_blocks.0.img_attn.norm.query_norm.scale", "double_blocks.0.txt_mlp.2.weight",
            "single_blocks.0.norm.key_norm.scale", "final_layer.adaLN_modulation.1.weight"} <= names
    with pytest.raises(KeyError):
        create_flux("flux-dev", device="meta")
    with pytest.raises(ValueError, match="axes_dim"):
        Flux(**dict(CFG, axes_dim=(8, 8, 8)), device="meta")


def test_each_block_call_records_one_span():
    from fit_tpu_torch.utils import profiling

    model = tiny_flux(5)
    x = inputs(5, 8, 8)
    profiling.clear()
    with torch.no_grad():
        model(**x)
    names = [e.name for e in profiling.recorded() if e.name.startswith("flux.")]
    assert names == ["flux.double"] * 2 + ["flux.single"] * 2
    assert all(e.kind == profiling.SPAN for e in profiling.recorded() if e.name.startswith("flux."))


def test_the_benchmark_reference_is_a_copy_of_the_plain_reference():
    assert filecmp.cmp(REPO / "tests" / "plain_flux.py", REPO / "bench_torch" / "reference" / "flux.py", shallow=False)
