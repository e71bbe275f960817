"""fit_tpu_torch's DiT-MoE (``models/moe.py``, ``FiTBlock(ffn="sparse_moe")``,
the ``DiT`` MoE arguments) against the plain fp32 reference
``tests/plain_ditmoe.py``, which imports nothing of the port.

All fp32 on the CPU, where the block takes its plain route (the loop over
experts), at the contract's size: hidden 96, 6 heads, depth 2, a 16x16
latent (T 64), 4 experts, top-2, a shared expert of width 192 (expert
width 4 x 96). Tolerance 3e-5: fp32 with another summation order (the
port sums each token's two experts in slot order, the reference in expert
order, and multiplies as stacked GEMMs), the bar of
tests/test_torch_port_dit.py. Routing must be identical: both take the
fp32 softmax of the same fp32 product. The 3-step DDIM latents grow like a
random-weight model's do, so they are held at max(1e-4, 2e-6 of the
largest magnitude), as in tests/test_torch_port_dit.py.
"""

import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_ditmoe as plain
from fit_tpu_torch.diffusion.gaussian import create_diffusion
from fit_tpu_torch.diffusion.samplers import ddim_sample_loop
from fit_tpu_torch.models import moe
from fit_tpu_torch.models.dit import DiT, DiT_MoE_models, create_dit
from fit_tpu_torch.models.layers import FiTBlock
from fit_tpu_torch.ops import fused_adaln
from fit_tpu_torch.sampling import cast_for_sampling

HID, HEADS, DEPTH, P, C, SIDE = 96, 6, 2, 2, 4, 16
T = (SIDE // P) ** 2  # 64 tokens
E, K, SHARED, NUM_CLASSES = 4, 2, 192, 10
ATOL = 3e-5
CFG = dict(hidden_size=HID, num_heads=HEADS, depth=DEPTH, patch_size=P, num_classes=NUM_CLASSES,
           num_experts_per_tok=K)
REPO = Path(__file__).resolve().parents[1]


def randomise(module, seed, std=0.05):
    """Every parameter normal(0, std) from numpy's seed (the reference init
    zeroes adaLN and the final layer)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.from_numpy(rng.normal(scale=std, size=tuple(p.shape)).astype(np.float32)))
    return module


def tiny_dit(seed=0):
    model = DiT(input_size=SIDE, patch_size=P, in_channels=C, hidden_size=HID, depth=DEPTH, num_heads=HEADS,
                num_classes=NUM_CLASSES, num_experts=E, num_experts_per_tok=K, shared_hidden=SHARED, device="cpu")
    return randomise(model, seed)


def weights(module, prefix=""):
    return {prefix + k: v.detach() for k, v in module.state_dict().items()}


def skewed_block(seed):
    """A block and an input on which expert 3 gets no row and expert 0 is
    one of nearly every token's two: the rows share a direction u, which
    the router's row 0 follows and row 3 opposes."""
    block = randomise(moe.SparseMoeBlock(HID, 4 * HID, E, K, SHARED, device="cpu"), seed)
    rng = np.random.default_rng(seed + 100)
    u = rng.normal(size=HID)
    u /= np.linalg.norm(u)
    x = rng.normal(scale=0.3, size=(3, T, HID)) + 2.0 * u
    with torch.no_grad():
        block.gate[0] = torch.from_numpy(4.0 * u).float()
        block.gate[3] = torch.from_numpy(-4.0 * u).float()
    return block, torch.from_numpy(x).float()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparse_moe_block_matches_the_plain_reference(seed):
    block, x = skewed_block(seed)
    idx, _ = moe.route(x.reshape(-1, HID), block.gate, K)
    counts = torch.bincount(idx.reshape(-1), minlength=E)
    assert counts[3] == 0 and counts[0] >= 0.9 * x.shape[0] * T, counts
    with torch.no_grad():
        got = block(x, torch.float32)
    want = plain.sparse_moe(weights(block, "ffn."), "ffn.", x.reshape(-1, HID), K).reshape(x.shape)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_routing_is_identical_to_the_reference(seed):
    block, x = skewed_block(seed)
    rng = np.random.default_rng(seed)
    for rows in (x.reshape(-1, HID), torch.from_numpy(rng.normal(size=(200, HID))).float()):
        idx, w = moe.route(rows, block.gate, K)
        assert torch.equal(idx, plain.routes(weights(block, "ffn."), "ffn.", rows, K))
        assert w.dtype == torch.float32 and torch.all(w[:, 0] >= w[:, 1])
        # not renormalised: the two scores sum to less than 1
        assert torch.all(w.sum(-1) < 1.0)


def test_dispatch_sorts_stably_and_ends_on_the_device_counts():
    idx = torch.tensor([[2, 0], [0, 2], [3, 0], [0, 1]])
    order, ends, pos = moe.dispatch(idx, 5)
    assert order.tolist() == [1, 2, 5, 6, 7, 0, 3, 4]  # expert 0's rows in token order, then 1, 2, 3
    assert ends.dtype == torch.int32 and ends.tolist() == [4, 5, 7, 8, 8]  # expert 4 has none
    flat = idx.reshape(-1)
    assert torch.equal(order[pos.reshape(-1)], torch.arange(8)) and torch.equal(flat[order], flat.sort().values)


def test_swiglu_halves_is_swiglu_of_the_two_halves():
    gu = torch.randn(5, 7, 2 * 24, dtype=torch.float64).float()
    got = fused_adaln.swiglu_halves(gu)
    assert got.shape == (5, 7, 24)
    torch.testing.assert_close(got, torch.nn.functional.silu(gu[..., :24]) * gu[..., 24:], rtol=0, atol=1e-6)
    assert torch.equal(fused_adaln.swiglu_halves(gu, plain=True), got)


def test_moe_combine_is_the_weighted_sum_of_each_tokens_rows_plus_shared():
    rng = np.random.default_rng(7)
    ys = torch.from_numpy(rng.normal(size=(10, 16)).astype(np.float32))
    pos = torch.from_numpy(rng.permutation(10).reshape(5, 2))
    w = torch.from_numpy(rng.uniform(size=(5, 2)).astype(np.float32))
    shared = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32))
    want = torch.stack([w[i, 0] * ys[pos[i, 0]] + w[i, 1] * ys[pos[i, 1]] for i in range(5)])
    torch.testing.assert_close(fused_adaln.moe_combine(ys, pos, w, 0 * shared), want, rtol=0, atol=1e-6)
    torch.testing.assert_close(fused_adaln.moe_combine(ys, pos, w, shared), want + shared, rtol=0, atol=1e-6)
    half = fused_adaln.moe_combine(ys.bfloat16(), pos, w, shared.bfloat16())
    assert half.dtype == torch.bfloat16


def _x_t_y(seed, n=3):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, C, SIDE, SIDE)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 1000, size=n))
    y = torch.from_numpy(rng.integers(0, NUM_CLASSES, size=n))
    return x, t, y


@pytest.mark.parametrize("seed", [0, 1])
def test_tiny_ditmoe_forward_matches_the_plain_reference(seed):
    model = tiny_dit(seed)
    x, t, y = _x_t_y(seed)
    with torch.no_grad():
        got = model(x, t, y, train=False)
    want = plain.forward(weights(model), dict(CFG, num_classes=NUM_CLASSES), x, t, y)
    assert got.shape == (3, 2 * C, SIDE, SIDE)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_tiny_ditmoe_forward_with_cfg_matches_the_plain_reference(seed):
    model = tiny_dit(seed)
    x, t, y = _x_t_y(seed + 10)
    with torch.no_grad():
        got = model.forward_with_cfg(torch.cat([x, x]), torch.cat([t, t]),
                                     torch.cat([y, torch.full_like(y, NUM_CLASSES)]), 1.5)
    want = plain.guided_eps(weights(model), CFG, x, t, y, 1.5)
    np.testing.assert_allclose(got[:3, :C].numpy(), want.numpy(), atol=ATOL, rtol=0)


def test_tiny_ditmoe_ddim_latents_match_the_plain_reference():
    model = tiny_dit(3)
    z, _, y = _x_t_y(3)
    steps, scale = 3, 1.5
    diffusion = create_diffusion(str(steps), learn_sigma=True)
    y2 = torch.cat([y, torch.full_like(y, NUM_CLASSES)])
    with torch.no_grad():
        got = ddim_sample_loop(diffusion, lambda x, t: model.forward_with_cfg(x, t, y2, scale), torch.cat([z, z]),
                               clip_denoised=False)[:3]
        want = plain.ddim(lambda x, t: plain.guided_eps(weights(model), CFG, x, t, y, scale), z, steps)
    tol = max(1e-4, 2e-6 * want.abs().max().item())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=0)


def test_the_bf16_cpu_forward_keeps_the_router_in_fp32():
    model = cast_for_sampling(DiT(input_size=SIDE, hidden_size=HID, depth=1, num_heads=HEADS,
                                  num_classes=NUM_CLASSES, num_experts=E, shared_hidden=SHARED,
                                  dtype=torch.bfloat16, device="cpu"), torch.device("cpu"))
    ffn = model.blocks[0].ffn
    assert ffn.gate.dtype == torch.float32 and ffn.w_gate_up.dtype == torch.bfloat16
    assert model.blocks[0].adaLN.weight.dtype == torch.bfloat16
    x, t, y = _x_t_y(4, n=2)
    with torch.no_grad():
        out = model(x, t, y, train=False)
    assert out.shape == (2, 2 * C, SIDE, SIDE) and torch.isfinite(out).all()


def test_the_registry_holds_the_published_sizes_and_g_counts_16_5b():
    assert list(DiT_MoE_models) == ["DiT-MoE-S/2-8E2A", "DiT-MoE-B/2-8E2A", "DiT-MoE-XL/2-8E2A", "DiT-MoE-G/2-16E2A"]
    g = create_dit("DiT-MoE-G/2-16E2A", device="meta")
    assert (g.depth, g.hidden_size, g.num_heads, g.patch_size) == (40, 1408, 16, 2)
    ffn = g.blocks[0].ffn
    assert (ffn.num_experts, ffn.top_k, ffn.hidden, ffn.shared_hidden) == (16, 2, 5632, 2816)
    assert sum(p.numel() for p in g.parameters()) == 16_503_356_704
    xl = DiT_MoE_models["DiT-MoE-XL/2-8E2A"](device="meta")
    assert sum(p.numel() for p in xl.parameters()) == 4_167_869_216
    with pytest.raises(KeyError):
        create_dit("DiT-MoE-G/2-8E2A", device="meta")


def test_the_switch_moe_still_raises():
    with pytest.raises(ValueError, match=r"item 9\)"):
        FiTBlock(HID, HEADS, ffn="moe", device="cpu")
    with pytest.raises(ValueError, match="int8"):
        FiTBlock(HID, HEADS, quant="int8", ffn="sparse_moe", num_experts=E, device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        moe.SparseMoeBlock(HID, 4 * HID, E, top_k=E + 1, shared_hidden=SHARED, device="cpu")
    with pytest.raises(ValueError, match="shared expert"):  # DiT-MoE always has one
        FiTBlock(HID, HEADS, ffn="sparse_moe", num_experts=E, device="cpu")


def test_the_moe_block_records_a_span_and_its_routed_rows():
    from fit_tpu_torch.utils import profiling

    block, x = skewed_block(0)
    profiling.clear()
    with torch.no_grad():
        block(x, torch.float32)
    spans = [e for e in profiling.recorded() if e.name == "moe.ffn"]
    counts = [e for e in profiling.recorded() if e.name == "moe.rows"]
    assert len(spans) == 1 and spans[0].kind == profiling.SPAN
    assert [c.attrs["n"] for c in counts] == [x.shape[0] * T * K]


def test_the_benchmark_reference_is_a_copy_of_the_plain_reference():
    assert filecmp.cmp(REPO / "tests" / "plain_ditmoe.py", REPO / "bench_torch" / "reference" / "ditmoe.py",
                       shallow=False)
