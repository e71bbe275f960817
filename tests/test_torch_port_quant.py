"""fit_tpu_torch.ops.quant and ops.fused_adaln against fit_tpu's.

On the CPU every kernel wrapper of the port runs its plain PyTorch version;
fit_tpu's Pallas kernels run in interpret mode (as tests/test_quant.py runs
them), with block_t=16 over a ragged T of 33 so their token grid has a tail.
Inputs are made with numpy from seeds and handed to both.

Tolerances:
- ``dynamic_quant`` and the int8 products: codes, scales and int32
  accumulators equal (the same fp32 arithmetic; integer sums are exact).
  The dequantized output within 1e-6 relative: the same fp32 epilogue, which
  XLA may contract into an FMA.
- ``quantize_params``: bit-identical (the same numpy arithmetic).
- The fused quant epilogues: int8 codes equal except for a ±1 step where a
  sum taken in another order moves a value across a rounding boundary, on
  at most 1% of the codes; row scales within 1e-6 relative (the absmax of
  the same fp32 values, up to that reordering).
- The fused glue: 2e-6 relative in fp32 (LayerNorm statistics summed in
  another order); one bf16 ulp in bf16 (the same fp32 value, rounded once).
  The unfused bf16 composition rounds after each op, and XLA splits silu
  into g * sigmoid(g) where PyTorch rounds one silu: 4 bf16 ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fit_tpu.ops.fused_adaln as j_fused
import fit_tpu.ops.quant as jq
from fit_tpu.core.pos_embed import rope_freqs_2d
from fit_tpu.models import FiT as JaxFiT
from fit_tpu_torch.models.fit import FiT
from fit_tpu_torch.models.from_jax import torch_state_dict_from_flax
from fit_tpu_torch.ops import fused_adaln, quant

HID, HEADS, DEPTH, T = 96, 6, 2, 64
NUM_CLASSES = 10


def _bf16(a: np.ndarray, dtype):
    """The same values for both packages: numpy fp32, rounded to bf16 once."""
    t = torch.from_numpy(a).to(dtype)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def assert_codes_close(q_got, s_got, q_want, s_want):
    q_got, q_want = np.asarray(q_got, np.int32), np.asarray(q_want, np.int32)
    assert q_got.shape == q_want.shape
    diff = np.abs(q_got - q_want)
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= 0.01, (diff > 0).mean()
    np.testing.assert_allclose(np.asarray(s_got), np.asarray(s_want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("prequantized", [False, True], ids=["float-input", "pair-input"])
def test_dynamic_quant_and_int8_matmul_match_jax(prequantized):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 40, 96)).astype(np.float32)
    w = (rng.normal(size=(96, 128)) * 0.05).astype(np.float32)  # flax (K, N)
    bias = (rng.normal(size=(128,)) * 0.1).astype(np.float32)
    wq, ks = jq._quantize_kernel(w)

    jxq, jsx = jq.dynamic_quant(jnp.asarray(x))
    txq, tsx = quant.dynamic_quant(torch.from_numpy(x))
    assert txq.dtype == torch.int8 and tsx.dtype == torch.float32 and tsx.shape == (3, 40, 1)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))

    weight = torch.from_numpy(np.ascontiguousarray(wq.T))  # the port's (N, K)
    want_acc = jax.lax.dot_general(jxq, jnp.asarray(wq), (((2,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    got_acc = quant._int_mm(txq.reshape(-1, 96), weight.t()).reshape(3, 40, 128)
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))

    x_in = (txq, tsx) if prequantized else torch.from_numpy(x)
    jx_in = (jxq, jsx) if prequantized else jnp.asarray(x)
    got = quant.int8_matmul(x_in, weight, torch.from_numpy(ks), torch.from_numpy(bias), out_dtype=torch.float32)
    want = jq.int8_matmul(jx_in, jnp.asarray(wq), jnp.asarray(ks), jnp.asarray(bias), out_dtype=jnp.float32)
    assert got.shape == (3, 40, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_int8_linear_takes_float_or_pair():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 8, 32)).astype(np.float32))
    layer = quant.Int8Linear(32, 16)
    wq, ks = quant._quantize_weight(rng.normal(size=(16, 32)).astype(np.float32) * 0.1)
    layer.load_state_dict({
        "weight": torch.from_numpy(wq),
        "kernel_scale": torch.from_numpy(ks),
        "bias": torch.from_numpy(rng.normal(size=(16,)).astype(np.float32)),
    })
    assert not list(layer.parameters()) and layer.weight.dtype == torch.int8
    a = layer(x, torch.float32)
    b = layer(quant.dynamic_quant(x), torch.float32)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert layer(x, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("fn", ["adaln_quant", "silu_mul_quant"])
def test_plain_quant_epilogues_match_pallas(fn, dtype):
    rng = np.random.default_rng(5)
    if fn == "adaln_quant":
        x, jx = _bf16(rng.normal(size=(2, 33, 64)).astype(np.float32) * 3 + 1, dtype)
        shift, jshift = _bf16(rng.normal(size=(2, 64)).astype(np.float32), dtype)
        scale, jscale = _bf16(rng.normal(size=(2, 64)).astype(np.float32), dtype)
        q, s = quant.adaln_quant(x, shift, scale)
        jqv, js = jq.adaln_quant(jx, jshift, jscale, block_t=16)
    else:
        g, jg = _bf16(rng.normal(size=(3, 33, 96)).astype(np.float32) * 2, dtype)
        v, jv = _bf16(rng.normal(size=(3, 33, 96)).astype(np.float32), dtype)
        q, s = quant.silu_mul_quant(g, v)
        jqv, js = jq.silu_mul_quant(jg, jv, block_t=16)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == tuple(js.shape) == (*q.shape[:2], 1)
    assert_codes_close(q.numpy(), s.numpy(), jqv, js)
    # on a CPU tensor the wrapper is its plain version
    ref = quant.adaln_quant_reference(x, shift, scale) if fn == "adaln_quant" else quant.silu_mul_quant_reference(g, v)
    torch.testing.assert_close(ref[0], q, rtol=0, atol=0)


def _assert_within_bf16_ulps(got: torch.Tensor, want: np.ndarray, ulps: int):
    a = got.view(torch.int16).int()
    b = torch.from_numpy(np.asarray(want.astype(np.float32))).to(torch.bfloat16).view(torch.int16).int()
    order = lambda i: torch.where(i < 0, -(i & 0x7FFF), i)  # noqa: E731 — sign-magnitude to ordered ints
    assert (order(a) - order(b)).abs().max().item() <= ulps


@pytest.mark.parametrize("use_kernel", [True, False], ids=["fused", "composition"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("fn", ["adaln_modulate", "swiglu_glue"])
def test_plain_glue_matches_pallas(fn, dtype, use_kernel):
    rng = np.random.default_rng(6)
    if fn == "adaln_modulate":
        x, jx = _bf16(rng.normal(size=(2, 33, 64)).astype(np.float32) * 3 + 1, dtype)
        shift, jshift = _bf16(rng.normal(size=(2, 64)).astype(np.float32), dtype)
        scale, jscale = _bf16(rng.normal(size=(2, 64)).astype(np.float32), dtype)
        got = fused_adaln.adaln_modulate(x, shift, scale, use_kernel=use_kernel)
        want = j_fused.adaln_modulate(jx, jshift, jscale, use_kernel=use_kernel)
    else:
        g, jg = _bf16(rng.normal(size=(3, 33, 96)).astype(np.float32) * 2, dtype)
        v, jv = _bf16(rng.normal(size=(3, 33, 96)).astype(np.float32), dtype)
        got = fused_adaln.swiglu_glue(g, v, use_kernel=use_kernel)
        want = j_fused.swiglu_glue(jg, jv, use_kernel=use_kernel)
    assert got.dtype == dtype and got.shape == tuple(want.shape)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)
    else:
        _assert_within_bf16_ulps(got, want, 1 if use_kernel else 4)


def _jax_params(scan: bool, seed: int = 5):
    jm = JaxFiT(
        patch_size=2, in_channels=4, hidden_size=HID, depth=DEPTH, num_heads=HEADS,
        num_classes=NUM_CLASSES, class_dropout_prob=0.0, attn_backend="xla", scan_blocks=scan,
    )
    rng = np.random.default_rng(seed)
    tokens = rng.normal(size=(2, T, 16)).astype(np.float32)
    pos = np.broadcast_to(rope_freqs_2d(HID // HEADS, 8, 8), (2, T, HID // HEADS)).astype(np.float32)
    params = jm.init(
        {"params": jax.random.PRNGKey(0), "label_dropout": jax.random.PRNGKey(1)},
        jnp.asarray(tokens), jnp.zeros((2,), jnp.int32), jnp.zeros((2,), jnp.int32),
        jnp.asarray(pos), jnp.ones((2, T), bool), train=True,
    )
    leaves, td = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jm, jax.tree.unflatten(td, [0.05 * jax.random.normal(k, l.shape, l.dtype) for k, l in zip(keys, leaves)])


def _port_model(quant_mode="none"):
    return FiT(
        patch_size=2, in_channels=4, hidden_size=HID, depth=DEPTH, num_heads=HEADS,
        num_classes=NUM_CLASSES, class_dropout_prob=0.0, quant=quant_mode,
    )


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan-stacked"])
def test_quantize_params_bit_identical_to_jax(scan):
    _, params = _jax_params(scan)
    want = torch_state_dict_from_flax(jax.tree.map(np.asarray, jq.quantize_params(params)), DEPTH)
    float_sd = torch_state_dict_from_flax(jax.tree.map(np.asarray, params), DEPTH)
    got = quant.quantize_params(float_sd)
    assert set(got) == set(want) == set(_port_model("int8").state_dict())
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)
    assert want["blocks.1.attn.qkv.weight"].dtype == torch.int8
    assert want["blocks.1.attn.qkv.kernel_scale"].shape == (3 * HID,)
    assert want["blocks.0.ffn.fc2.kernel_scale"].dtype == torch.float32
    assert want["x_embedder.weight"].dtype == torch.float32  # outside QUANT_KERNEL_PATHS

    # quantize_model: the same weights in a new int8 FiT
    fm = _port_model()
    fm.load_state_dict(float_sd)
    qm = quant.quantize_model(fm)
    assert qm.quant == "int8" and isinstance(qm.blocks[0].attn.qkv, quant.Int8Linear)
    for key, value in qm.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want[key].numpy(), err_msg=key)


def test_quantized_artifact_round_trip(tmp_path):
    _, params = _jax_params(False, seed=6)
    sd = quant.quantize_params(torch_state_dict_from_flax(jax.tree.map(np.asarray, params), DEPTH))
    path = str(tmp_path / "int8")
    assert not quant.is_quantized_artifact(path)
    quant.save_quantized(path, sd, meta={"model": "tiny"})
    assert quant.is_quantized_artifact(path)
    loaded, meta = quant.load_quantized(path)
    assert meta == {"scheme": "w8a8-int8", "model": "tiny"}
    assert set(loaded) == set(sd)
    for key in sd:
        assert loaded[key].dtype == sd[key].dtype
        torch.testing.assert_close(loaded[key], sd[key], rtol=0, atol=0)
    model = _port_model("int8")
    model.load_state_dict(loaded)
    assert model.blocks[0].ffn.fc1_g.weight.dtype == torch.int8
