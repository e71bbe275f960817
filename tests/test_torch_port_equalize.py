"""fit_tpu_torch.ops.equalize (SmoothQuant) against fit_tpu's.

The contract-size model (hidden 96, 6 heads, depth 2, T 64) with random
fp32 weights, carried from fit_tpu's unrolled param tree by
``torch_state_dict_from_flax``; calibration batches from both packages'
``synthetic_calib_batch`` on the same numpy seeds.

Tolerances:
- ``calibrate``: per-channel absmax within 1e-5 relative (the same fp32
  forward, summed in another order: 3e-5 absolute on outputs of order 1).
- ``equalize_params``: the same fp64 folds of the same fp32 values, cast
  once: within one fp32 rounding (rtol 1e-6).
- An equalized fp32 model's forward: unchanged within fit_tpu's own bar
  for it (rtol 2e-4, atol 2e-5 of the largest output).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fit_tpu.models import FiT as JaxFiT
from fit_tpu.ops.equalize import calibrate as j_calibrate
from fit_tpu.ops.equalize import equalize_params as j_equalize
from fit_tpu.ops.equalize import synthetic_calib_batch as j_batch
from fit_tpu_torch.models.fit import FiT
from fit_tpu_torch.models.from_jax import torch_state_dict_from_flax
from fit_tpu_torch.ops.equalize import calibrate, equalize_params, synthetic_calib_batch
from fit_tpu_torch.ops.quant import load_quantized, quantize_model, save_quantized

HID, HEADS, DEPTH = 96, 6, 2
NUM_CLASSES = 10
SIZE = 128  # 16 x 16 latents: T 64 at patch 2


def jax_model(ffn="swiglu"):
    return JaxFiT(patch_size=2, in_channels=4, hidden_size=HID, depth=DEPTH, num_heads=HEADS,
                  num_classes=NUM_CLASSES, class_dropout_prob=0.1, attn_backend="xla", scan_blocks=False, ffn=ffn)


def port_model(ffn="swiglu"):
    return FiT(patch_size=2, in_channels=4, hidden_size=HID, depth=DEPTH, num_heads=HEADS,
               num_classes=NUM_CLASSES, ffn=ffn, device="cpu")


def random_params(model, seed=7, amp=0.1):
    """fit_tpu params with weight mass everywhere (a fresh init zeroes the
    adaLN gates, which would make every block the identity)."""
    params = model.init(
        {"params": jax.random.PRNGKey(0), "label_dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 8, 16)), jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 8, HID // HEADS)), jnp.ones((1, 8), bool), train=True,
    )
    leaves, td = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree.unflatten(td, [amp * jax.random.normal(k, l.shape, jnp.float32) for k, l in zip(keys, leaves)])


@pytest.fixture(scope="module", params=["swiglu", "mlp"])
def models(request):
    jm = jax_model(request.param)
    params = random_params(jm)
    tm = port_model(request.param)
    tm.load_state_dict(torch_state_dict_from_flax(jax.tree.map(np.asarray, params), DEPTH))
    return jm, params, tm


def batches(make, model, n=2, seed=3):
    rng = np.random.default_rng(seed)
    return [make(model, rng, batch=3, size=SIZE) for _ in range(n)]


def test_synthetic_batches_are_fit_tpus():
    jm, tm = jax_model(), port_model()
    for (jx, jt, jy, jpos, jmask), (x, t, y, pos, mask) in zip(batches(j_batch, jm), batches(synthetic_calib_batch, tm)):
        for a, b in ((jx, x), (jt, t), (jy, y), (jpos, pos), (jmask, mask)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_calibrate_matches_jax(models):
    jm, params, tm = models
    want = j_calibrate(jm, params, batches(j_batch, jm))
    got = calibrate(tm, batches(synthetic_calib_batch, tm))
    assert set(got) == set(want)  # fc2_in only for SwiGLU
    for site in want:
        assert got[site].shape == want[site].shape and got[site].dtype == np.float32
        np.testing.assert_allclose(got[site], want[site], rtol=1e-5, atol=1e-5 * float(want[site].max()))


def test_equalize_params_matches_jax(models):
    jm, params, tm = models
    stats = j_calibrate(jm, params, batches(j_batch, jm))
    want = torch_state_dict_from_flax(jax.tree.map(np.asarray, j_equalize(params, stats, alpha=0.5)), DEPTH)
    got = equalize_params(tm.state_dict(), stats, alpha=0.5)
    assert set(got) == set(want)
    changed = 0
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-9, msg=k)
        changed += not torch.equal(got[k], tm.state_dict()[k])
    assert changed >= DEPTH * 5  # adaLN, qkv, proj and fc1 of each block at least


def test_equalized_fp32_forward_is_unchanged(models):
    _, _, tm = models
    x, t, y, pos, mask = batches(synthetic_calib_batch, tm, n=1, seed=5)[0]
    eq = port_model("swiglu" if hasattr(tm.blocks[0].ffn, "fc1_x") else "mlp")
    eq.load_state_dict(equalize_params(tm.state_dict(), calibrate(tm, batches(synthetic_calib_batch, tm))))
    with torch.no_grad():
        want = tm(x, t, y, pos, mask, train=False).numpy()
        got = eq(x, t, y, pos, mask, train=False).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5 * np.abs(want).max())


def _with_outliers(tm):
    """Activation-outlier channels in every int8 feed, as trained
    checkpoints grow them: large adaLN shift biases (attn_in, ffn_in),
    large fc1_x rows (the SwiGLU hidden) and large v rows of qkv (the
    attention output)."""
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    for i in range(DEPTH):
        bias = sd[f"blocks.{i}.adaLN.bias"]
        for chunk in (0, 3):
            bias[chunk * HID + 3] += 30.0
            bias[chunk * HID + 11] -= 25.0
        sd[f"blocks.{i}.ffn.fc1_x.weight"][5] *= 25.0
        sd[f"blocks.{i}.attn.qkv.weight"][2 * HID + 7] *= 25.0
    model = port_model()
    model.load_state_dict(sd)
    return model


def test_equalization_lowers_int8_error_on_outliers():
    jm = jax_model()
    tm = port_model()
    tm.load_state_dict(torch_state_dict_from_flax(jax.tree.map(np.asarray, random_params(jm, amp=0.08)), DEPTH))
    model = _with_outliers(tm)
    x, t, y, pos, mask = batches(synthetic_calib_batch, model, n=1, seed=5)[0]
    with torch.no_grad():
        ref = model(x, t, y, pos, mask, train=False)

        def int8_err(calib):
            q = quantize_model(model, calib_batches=calib)
            return float((q(x, t, y, pos, mask, train=False) - ref).pow(2).mean().sqrt())

        plain = int8_err(None)
        equalized = int8_err(batches(synthetic_calib_batch, model))
    assert equalized < 0.7 * plain, (equalized, plain)


def test_equalized_artifact_round_trip(tmp_path):
    params = random_params(jax_model())
    tm = port_model()
    tm.load_state_dict(torch_state_dict_from_flax(jax.tree.map(np.asarray, params), DEPTH))
    q = quantize_model(tm, calib_batches=batches(synthetic_calib_batch, tm, n=1))
    save_quantized(str(tmp_path / "art"), q.state_dict(), meta={"equalized_batches": 1})
    loaded, meta = load_quantized(str(tmp_path / "art"))
    assert meta["equalized_batches"] == 1 and meta["scheme"] == "w8a8-int8"
    want = q.state_dict()
    assert list(loaded) == list(want)
    for k in want:
        assert loaded[k].dtype == want[k].dtype and torch.equal(loaded[k], want[k]), k
    assert loaded["blocks.0.attn.qkv.weight"].dtype == torch.int8
