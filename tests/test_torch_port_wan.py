"""fit_tpu_torch's Wan2.1 (``models/wan.py``, ``diffusion/flow.py``'s guided
loop, the 3-axis RoPE tables, and the plain versions of K8W, the
cross-attention entry and the mixed-dtype K5/K5R) against the plain fp32
reference ``tests/plain_wan.py``, which imports nothing of the port.

All fp32 on the CPU at a tiny size: dim 256, 2 heads of 128 (RoPE axes 44,
42, 42), FFN 512, 2 blocks, 16-channel latents of 3 x 8 x 12 (a 3 x 4 x 6
token grid, 72 tokens), 8 text rows of width 64. Tolerance 3e-5, the bar of
tests/test_torch_port_flux.py; the guided Euler latents at max(1e-4, 2e-6
of the largest magnitude). The block's fused route (the card's, with K5,
K5R, K8W, K6G, K1 and the cross entry) runs here with every kernel
wrapper's plain version, against the released composition of the eager
route.
"""

import filecmp
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_wan as plain
from fit_tpu_torch.core.pos_embed import rope_ids_nd
from fit_tpu_torch.diffusion import flow
from fit_tpu_torch.models import wan
from fit_tpu_torch.models.wan import WanModel, create_wan
from fit_tpu_torch.ops import fused_adaln, launch_counts, reset_launches
from fit_tpu_torch.ops import rope_attention as ra

CFG = dict(patch_size=(1, 2, 2), text_len=8, in_dim=16, dim=256, ffn_dim=512, freq_dim=256, text_dim=64, out_dim=16,
           num_heads=2, num_layers=2)
ATOL = 3e-5
LATENT = (3, 8, 12)  # (F, H, W): a 3 x 4 x 6 token grid
REPO = Path(__file__).resolve().parents[1]


def tiny_wan(seed=0, std=0.05):
    """Every parameter normal(0, std) from numpy's seed; the RMSNorm and
    norm3 weights about 1."""
    model = WanModel(**CFG, device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            mean, s = (1.0, 0.1) if name.endswith(("norm_q.weight", "norm_k.weight", "norm3.weight")) else (0.0, std)
            p.copy_(torch.from_numpy(rng.normal(mean, s, size=tuple(p.shape)).astype(np.float32)))
    return model


def weights(model):
    return {k: v.detach() for k, v in model.state_dict().items()}


def inputs(seed, n=2):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    return dict(x=draw(n, 16, *LATENT), t=torch.from_numpy(rng.uniform(0, 1000, size=n).astype(np.float32)),
                context=draw(n, 8, 64))


@pytest.mark.parametrize("seed", [0, 1])
def test_tiny_wan_forward_matches_the_plain_reference(seed):
    model = tiny_wan(seed)
    x = inputs(seed)
    with torch.no_grad():
        got = model(**x)
    want = plain.forward(weights(model), CFG, **x)
    assert got.shape == (2, 16, *LATENT) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def test_the_fused_route_with_plain_kernels_matches_the_eager_route(monkeypatch):
    """The card's route (K5 and K5R on the fp32 stream with norm3 and a gate
    of ones as conditioning rows, K8W in place, K1, the cross entry, K6G)
    run with each wrapper's plain version: the same forward, and no
    launch."""
    model = tiny_wan(3)
    x = inputs(3)
    with torch.no_grad():
        eager = model(**x)
        monkeypatch.setattr(wan, "fused_glue", lambda t, quant: True)
        reset_launches()
        model.plain_kernels = True
        fused = model(**x)
    assert launch_counts() == {k: 0 for k in launch_counts()}
    np.testing.assert_allclose(fused.numpy(), eager.numpy(), atol=ATOL, rtol=0)


def test_tiny_wan_guided_euler_latents_match_the_plain_reference():
    model = tiny_wan(4)
    x = inputs(4, n=1)
    null = torch.from_numpy(np.random.default_rng(9).normal(size=(1, 8, 64)).astype(np.float32))
    times = flow.shifted_schedule(3, 5.0)
    assert times == pytest.approx(plain.shifted_times(3, 5.0), abs=1e-15)
    got = flow.denoise_guided(model, x["x"], x["context"], null, times, 5.0)
    with torch.no_grad():
        want = plain.denoise(weights(model), CFG, x["x"], x["context"], null, times, 5.0)
    tol = max(1e-4, 2e-6 * want.abs().max().item())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=0)


def test_the_two_row_guided_batch_is_two_separate_calls():
    """A step's [cond | uncond] batch gives each row what a batch-1 call
    gives it (the released sampler's two calls)."""
    model = tiny_wan(6)
    x = inputs(6, n=1)
    null = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 8, 64)).astype(np.float32))
    t = torch.full((2,), 700.0)
    with torch.no_grad():
        both = model(torch.cat((x["x"], x["x"])), t, torch.cat((x["context"], null)))
        cond = model(x["x"], t[:1], x["context"])
        uncond = model(x["x"], t[:1], null)
    np.testing.assert_allclose(both[:1].numpy(), cond.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(both[1:].numpy(), uncond.numpy(), atol=1e-5, rtol=0)
    assert not torch.allclose(cond, uncond)


@pytest.mark.parametrize("grid", [(21, 30, 52), (3, 4, 6)])
def test_the_3_axis_tables_are_wans_rope_params_and_rope_apply(grid):
    """``rope_ids_nd`` at axes (44, 42, 42) through ``split_rope_tables``
    rotates as the released float64 ``rope_params`` / ``rope_apply`` do,
    written out here as the release has them."""
    d, heads = 128, 2
    assert wan.rope_axes(d) == (44, 42, 42)

    def rope_params(max_seq_len, dim, theta=10000):
        freqs = torch.outer(torch.arange(max_seq_len), 1.0 / torch.pow(
            theta, torch.arange(0, dim, 2).to(torch.float64).div(dim)))
        return torch.polar(torch.ones_like(freqs), freqs)

    freqs = torch.cat([rope_params(1024, d - 4 * (d // 6)), rope_params(1024, 2 * (d // 6)),
                       rope_params(1024, 2 * (d // 6))], dim=1)
    f, h, w = grid
    seq_len, c = f * h * w, d // 2
    x = torch.randn(1, seq_len, heads, d)
    parts = freqs.split([c - 2 * (c // 3), c // 3, c // 3], dim=1)
    freqs_i = torch.cat([parts[0][:f].view(f, 1, 1, -1).expand(f, h, w, -1),
                         parts[1][:h].view(1, h, 1, -1).expand(f, h, w, -1),
                         parts[2][:w].view(1, 1, w, -1).expand(f, h, w, -1)], dim=-1).reshape(seq_len, 1, -1)
    x_i = torch.view_as_complex(x[0].to(torch.float64).reshape(seq_len, heads, -1, 2))
    want = torch.view_as_real(x_i * freqs_i).flatten(2).float()
    model = WanModel(**dict(CFG, dim=heads * d, num_layers=0), device="meta")
    cos, sin = model.rope_tables(1, grid, "cpu")
    assert cos.shape == (1, seq_len, d) and cos.dtype == torch.float32
    got = x * cos[:, :, None] + ra.rotate_pairs(x) * sin[:, :, None]
    torch.testing.assert_close(got[0], want, rtol=0, atol=2e-5 * max(1.0, want.abs().max().item()))
    # token (1, 2, 3) turns the frame axis's first pair by 1, the rows' by 2 and the columns' by 3
    table = rope_ids_nd(torch.tensor([[[1.0, 2.0, 3.0]]]), (44, 42, 42))
    assert table[0, 0, 0] == pytest.approx(math.cos(1.0), abs=1e-7)
    assert table[0, 0, 44] == pytest.approx(math.cos(2.0), abs=1e-7)
    assert table[0, 0, 86] == pytest.approx(math.cos(3.0), abs=1e-7)


def test_the_full_width_norm_is_not_a_per_head_norm():
    """K8W's plain version normalises all D lanes of a row (the released
    ``WanRMSNorm``), in place by row stride, and differs from FLUX's per-head
    norm (K8's) wherever the heads' scales differ."""
    heads, d = 4, 32
    x = torch.randn(2, 5, heads * d) * torch.tensor([0.5, 1.0, 2.0, 4.0]).repeat_interleave(d)
    w = torch.rand(heads * d) + 0.5
    wide = torch.randn(2, 5, 3 * heads * d)
    wide[..., : heads * d] = x
    before = wide.clone()
    assert fused_adaln.qk_norm_wide(wide[..., : heads * d], w).data_ptr() == wide.data_ptr()
    xd = x.double()
    want = xd / xd.pow(2).mean(-1, keepdim=True).add(1e-6).sqrt() * w.double()
    torch.testing.assert_close(wide[..., : heads * d].double(), want, rtol=0, atol=1e-6)
    assert torch.equal(wide[..., heads * d :], before[..., heads * d :])
    per_head = fused_adaln.qk_norm_reference(x, w[:d], heads)
    assert (per_head - wide[..., : heads * d]).abs().max() > 0.5
    half = fused_adaln.qk_norm_wide(x.bfloat16(), w.bfloat16(), plain=True)
    assert half.dtype == torch.bfloat16
    # the release's cast: normed values rounded to bf16 before the weight's multiply
    xb = x.bfloat16().float()
    normed = (xb * torch.rsqrt(xb.square().mean(-1, keepdim=True) + 1e-6)).bfloat16()
    assert torch.equal(fused_adaln.qk_norm_wide_reference(x.bfloat16(), w.bfloat16()),
                       (normed.float() * w.bfloat16().float()).bfloat16())


@pytest.mark.parametrize("tq,tk,lens", [(7, 5, (5, 2)), (3, 11, (1, 11))])
def test_the_cross_entrys_plain_version_is_softmax_attention(tq, tk, lens):
    b, h, d = 2, 3, 16
    gen = torch.Generator().manual_seed(tq * tk)
    q, k, v = (torch.randn(b, t, h, d, generator=gen) for t in (tq, tk, tk))
    kl = torch.tensor(lens, dtype=torch.int32)
    got = ra.cross_attention(q, k, v, kl, d**-0.5)
    for i in range(b):
        qi, ki, vi = q[i].transpose(0, 1), k[i, : lens[i]].transpose(0, 1), v[i, : lens[i]].transpose(0, 1)
        want = torch.softmax(qi @ ki.transpose(-1, -2) * d**-0.5, dim=-1) @ vi
        torch.testing.assert_close(got[i], want.transpose(0, 1), rtol=0, atol=1e-6)
    out = torch.zeros(b, tq, h, 2 * d)[..., :d]
    assert ra.cross_attention(q, k, v, kl, d**-0.5, out=out).data_ptr() == out.data_ptr()
    assert torch.equal(out, got)
    assert ra.cross_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), kl, d**-0.5).dtype == torch.bfloat16


def test_the_mixed_row_kernels_keep_the_fp32_stream():
    """K5 and K5R's plain versions on an fp32 stream with a bf16 branch:
    x_new = x + gate * y in fp32, h rounded once to bf16."""
    x = torch.randn(2, 6, 64) * 3
    y = torch.randn(2, 6, 64).bfloat16()
    cond = torch.randn(2, 9, 64) * 0.3
    x_new, h = fused_adaln.adaln_residual(x, y, cond[:, 2], cond[:, 6], cond[:, 7], out_dtype=torch.bfloat16)
    assert x_new.dtype == torch.float32 and h.dtype == torch.bfloat16
    assert torch.equal(x_new, x + cond[:, 2, None] * y.float())
    assert torch.equal(h, fused_adaln.adaln_reference(x_new, cond[:, 6], cond[:, 7]).bfloat16())
    h1 = fused_adaln.adaln_modulate(x, cond[:, 0], cond[:, 1], out_dtype=torch.bfloat16)
    assert torch.equal(h1, fused_adaln.adaln_reference(x, cond[:, 0], cond[:, 1]).bfloat16())


def test_context_lens_limits_the_text_keys():
    """The released t2v sampler attends every text row (``context_lens``
    None); a length a row attends only its first keys, as the plain
    reference's mask does."""
    model = tiny_wan(7)
    x = inputs(7)
    lens = torch.tensor([3, 8])
    with torch.no_grad():
        full = model(**x)
        cut = model(**x, context_lens=lens)
    want = plain.forward(weights(model), CFG, **x, context_lens=lens)
    np.testing.assert_allclose(cut.numpy(), want.numpy(), atol=ATOL, rtol=0)
    assert (cut[0] - full[0]).abs().max() > 1e-3
    np.testing.assert_allclose(cut[1].numpy(), full[1].numpy(), atol=ATOL, rtol=0)


def test_patches_are_the_conv3ds_and_the_head_unpatchifies_channel_fastest():
    z = torch.randn(2, 16, *LATENT)
    tokens = wan.patchify(z)
    assert torch.equal(tokens, plain.patchify(z))
    assert tokens.shape == (2, 3 * 4 * 6, 64)
    # token (frame 1, row 2, col 3) is channel c's 2 x 2 patch, channel slowest
    assert torch.equal(tokens[0, (1 * 4 + 2) * 6 + 3].reshape(16, 2, 2), z[0, :, 1, 4:6, 6:8])
    conv = torch.nn.Conv3d(16, 8, kernel_size=(1, 2, 2), stride=(1, 2, 2))
    with torch.no_grad():
        want = conv(z).flatten(2).transpose(1, 2)
        got = torch.nn.functional.linear(tokens, conv.weight.reshape(8, -1), conv.bias)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    out = torch.randn(2, 72, 64)
    assert torch.equal(wan.unpatchify(out, (3, 4, 6)), plain.unpatchify(out, 3, 4, 6))
    assert torch.equal(wan.unpatchify(out, (3, 4, 6))[0, 5, 1, 2:4, 0:2].reshape(-1), out[0, 1 * 24 + 6, 5::16])


def test_the_shifted_schedule_is_wans():
    times = flow.shifted_schedule(50, 5.0)
    assert times[0] == 1.0 and times[-1] == 0.0 and len(times) == 51
    t = np.linspace(1, 0, 51)
    np.testing.assert_allclose(times, 5 * t / (1 + 4 * t), rtol=0, atol=1e-15)


def test_the_registry_holds_t2v_14bs_sizes():
    m = create_wan("wan2.1-t2v-14b", device="meta")
    assert (m.dim, m.num_heads, m.head_dim, len(m.blocks)) == (5120, 40, 128, 40)
    assert m.blocks[0].ffn[0].weight.shape == (13824, 5120)
    assert m.patch_embedding.weight.shape == (5120, 16, 1, 2, 2)
    assert m.text_embedding[0].weight.shape == (5120, 4096)
    assert m.time_projection[1].weight.shape == (6 * 5120, 5120)
    assert m.head.head.weight.shape == (64, 5120) and m.head.modulation.shape == (1, 2, 5120)
    assert m.blocks[0].self_attn.norm_q.weight.shape == (5120,) and m.blocks[0].modulation.shape == (1, 6, 5120)
    per_block = sum(p.numel() for p in m.blocks[0].parameters())
    assert per_block == 351_394_304
    assert sum(p.numel() for p in m.parameters()) == 14_288_491_584
    names = {n for n, _ in m.named_parameters()}
    assert {"blocks.0.self_attn.q.weight", "blocks.0.cross_attn.norm_k.weight", "blocks.0.norm3.bias",
            "blocks.0.ffn.2.weight", "blocks.39.modulation", "head.head.bias", "time_projection.1.weight",
            "text_embedding.2.weight", "patch_embedding.bias"} <= names
    with pytest.raises(KeyError):
        create_wan("wan2.1-t2v-1.3b", device="meta")


def test_sampling_casts_keep_the_fp32_parts():
    from fit_tpu_torch.sampling import cast_for_sampling

    model = cast_for_sampling(WanModel(**CFG, dtype=torch.bfloat16, device="cpu"), torch.device("cpu"))
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    fp32 = {n for n, dt in dtypes.items() if dt == torch.float32}
    assert fp32 == {"time_embedding.0.weight", "time_embedding.0.bias", "time_embedding.2.weight",
                    "time_embedding.2.bias", "time_projection.1.weight", "time_projection.1.bias",
                    "blocks.0.modulation", "blocks.1.modulation", "head.head.weight", "head.head.bias",
                    "head.modulation"}
    assert dtypes["blocks.0.self_attn.q.weight"] == torch.bfloat16
    x = inputs(8)
    with torch.no_grad():
        out = model(**x)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_each_block_call_records_its_spans_and_each_forward_its_counts():
    from fit_tpu_torch.utils import profiling

    model = tiny_wan(5)
    x = inputs(5)
    profiling.clear()
    with torch.no_grad():
        model(**x)
    got = [(e.name, e.kind) for e in profiling.recorded() if e.name.startswith("wan.")]
    assert got == ([("wan.video_tokens", profiling.COUNT), ("wan.text_keys", profiling.COUNT)]
                   + [("wan.self_attn", profiling.SPAN), ("wan.cross_attn", profiling.SPAN)] * 2)
    counts = {e.name: e.attrs["n"] for e in profiling.recorded() if e.kind == profiling.COUNT and e.name.startswith("wan.")}
    assert counts == {"wan.video_tokens": 2 * 72, "wan.text_keys": 2 * 8}


def test_the_benchmark_reference_is_a_copy_of_the_plain_reference():
    assert filecmp.cmp(REPO / "tests" / "plain_wan.py", REPO / "bench_torch" / "reference" / "wan.py", shallow=False)
