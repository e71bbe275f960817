"""fit_tpu_torch's DiT and FiT ``pos_kind="absolute"`` / ``ffn="mlp"``
against fit_tpu on the same weights and inputs.

Randomised flax params (the reference init is the zero function) go through
``torch_state_dict_from_flax`` into the port; the port (plain attention on
the CPU) is held against flax ``apply`` with the XLA attention and with the
Pallas ``_flash_kernel`` in interpret mode, as tests/test_attention.py runs
it. All fp32, at the contract's size (hidden 96, 6 heads, depth 2, a 16x16
latent: T 64). Tolerance 3e-5 on valid tokens: fp32 with another summation
order, the bar of tests/test_torch_parity.py. The sampler loops run the
same fp32 arithmetic on the same coefficients around those forwards, so
their per-step latents are compared at 1e-4 where they stay of order 1
(DDPM with x0 clipped). Without clipping a random-weight model's latents
grow to ~650 (the x0 prediction's 1/sqrt(alpha_bar), up to ~160), where
one fp32 ulp is ~6e-5, and DDIM re-derives eps from x0 through the same
factor; those runs are held at 2e-6 of the latents' largest magnitude
(about 16 ulp), as in tests/test_torch_port_sampling.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fit_tpu.core.pos_embed import sincos_2d as j_sincos_2d
from fit_tpu.diffusion import create_diffusion as j_create_diffusion
from fit_tpu.diffusion import ddim_sample_loop as j_ddim_loop
from fit_tpu.diffusion import p_sample_loop as j_p_loop
from fit_tpu.models import DiT as JaxDiT
from fit_tpu.models import FiT as JaxFiT
from fit_tpu.models.layers import GeluMlp as JaxGeluMlp
from fit_tpu.sampling import create_pos_embed as j_create_pos_embed
from fit_tpu_torch.core.pos_embed import sincos_2d
from fit_tpu_torch.diffusion.gaussian import create_diffusion
from fit_tpu_torch.diffusion.samplers import ddim_sample_loop, p_sample_loop
from fit_tpu_torch.models.dit import DiT, DiT_models, create_dit
from fit_tpu_torch.models.fit import FiT
from fit_tpu_torch.models.from_jax import torch_state_dict_from_flax
from fit_tpu_torch.models.layers import GeluMlp
from fit_tpu_torch.ops import launch_counts, reset_launches
from fit_tpu_torch.sampling import create_pos_embed

HID, HEADS, DEPTH, P, C, SIDE = 96, 6, 2, 2, 4, 16
T = (SIDE // P) ** 2  # 64 tokens
NUM_CLASSES = 10
ATOL = 3e-5


def randomise(params, seed, std=0.05):
    leaves, td = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree.unflatten(td, [std * jax.random.normal(k, l.shape, l.dtype) for k, l in zip(keys, leaves)])


def jax_dit(backend="xla"):
    return JaxDiT(
        input_size=SIDE, patch_size=P, in_channels=C, hidden_size=HID, depth=DEPTH, num_heads=HEADS,
        num_classes=NUM_CLASSES, attn_backend=backend,
    )


def torch_dit():
    return DiT(
        input_size=SIDE, patch_size=P, in_channels=C, hidden_size=HID, depth=DEPTH, num_heads=HEADS,
        num_classes=NUM_CLASSES,
    )


@pytest.fixture(scope="module")
def dit_params():
    x = jnp.zeros((2, C, SIDE, SIDE))
    params = jax_dit().init(
        {"params": jax.random.PRNGKey(0), "label_dropout": jax.random.PRNGKey(1)},
        x, jnp.zeros((2,), jnp.int32), jnp.zeros((2,), jnp.int32), train=True,
    )
    return params, randomise(params, 5)


def port_dit(params):
    model = torch_dit()
    model.load_state_dict(torch_state_dict_from_flax(jax.tree.map(np.asarray, params), DEPTH))
    return model.eval()


def dit_inputs(seed=0, n=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, C, SIDE, SIDE)).astype(np.float32)
    t = rng.integers(0, 1000, size=(n,)).astype(np.int32)
    y = rng.integers(0, NUM_CLASSES, size=(n,)).astype(np.int32)
    y[n // 2 :] = NUM_CLASSES  # the null-class half of a CFG batch
    return x, t, y


def test_sincos_tables_match_fit_tpu():
    """DiT-XL/2's 512^2 table (1152 wide, 32 x 32 patches) byte for byte, and
    the absolute inference table of create_pos_embed."""
    np.testing.assert_array_equal(sincos_2d(1152, 32, 32), np.asarray(j_sincos_2d(1152, 32, 32)))
    got, n = create_pos_embed(10, 14, P, T, HID, "absolute")
    want, jn = j_create_pos_embed(10, 14, P, T, HID, "absolute")
    assert n == jn == 35 and got.shape == (1, T, HID)
    np.testing.assert_array_equal(got, np.asarray(want))
    got, _ = create_pos_embed(10, 14, P, T, HID // HEADS)  # "rotate" stays the default
    np.testing.assert_array_equal(got, np.asarray(j_create_pos_embed(10, 14, P, T, HID // HEADS, "rotate")[0]))
    with pytest.raises(ValueError, match="unknown method"):
        create_pos_embed(10, 14, P, T, HID, "learned")


def test_gelu_mlp_matches_flax():
    x = np.random.default_rng(1).normal(size=(2, 5, HID)).astype(np.float32)
    jm = JaxGeluMlp(4 * HID, HID)
    params = randomise(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2, std=0.1)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    mlp = GeluMlp(HID, 4 * HID)
    mlp.load_state_dict(torch_state_dict_from_flax(jax.tree.map(np.asarray, params), 0))
    with torch.no_grad():
        got = mlp(torch.from_numpy(x), torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_dit_forward_matches_flax(dit_params, backend):
    _, params = dit_params
    x, t, y = dit_inputs()
    want = np.asarray(jax_dit(backend).apply(params, *(jnp.asarray(a) for a in (x, t, y)), train=False))
    reset_launches()
    with torch.no_grad():
        got = port_dit(params)(*(torch.from_numpy(a) for a in (x, t, y)), train=False).numpy()
    assert launch_counts()["masked_attention"] == 0  # CPU tensors: the plain version
    assert got.shape == want.shape == (4, 2 * C, SIDE, SIDE)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_dit_forward_with_cfg_matches_flax(dit_params, backend):
    """The guided forward: the first 3 channels guided, the others (the
    fourth eps channel and the variance) passed through."""
    _, params = dit_params
    x, t, y = dit_inputs(1)
    jm = jax_dit(backend)
    want = np.asarray(jm.apply(params, *(jnp.asarray(a) for a in (x, t, y)), 4.0, method=JaxDiT.forward_with_cfg))
    model = port_dit(params)
    with torch.no_grad():
        got = model.forward_with_cfg(*(torch.from_numpy(a) for a in (x, t, y)), 4.0).numpy()
        plain = model(torch.from_numpy(np.concatenate([x[:2], x[:2]])), torch.from_numpy(t), torch.from_numpy(y), False).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[:2, :3], plain[2:, :3] + 4.0 * (plain[:2, :3] - plain[2:, :3]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[:, 3:], plain[:, 3:])
    np.testing.assert_array_equal(got[:2, :3], got[2:, :3])  # the guided eps in both halves


def test_dit_reference_init_registry_and_converter(dit_params):
    init_params, params = dit_params
    x, t, y = dit_inputs(2)
    # the reference init predicts zero, in flax and in the port's own init
    assert not np.asarray(jax_dit().apply(init_params, *(jnp.asarray(a) for a in (x, t, y)), train=False)).any()
    with torch.no_grad():
        assert torch_dit()(*(torch.from_numpy(a) for a in (x, t, y)), train=False).abs().max() == 0
    sd = torch_state_dict_from_flax(jax.tree.map(np.asarray, params), DEPTH)
    assert set(sd) == set(torch_dit().state_dict())
    fc1 = np.asarray(params["params"]["blocks_1"]["ffn"]["fc1"]["kernel"])
    assert fc1.shape == (HID, 4 * HID)
    np.testing.assert_array_equal(sd["blocks.1.ffn.fc1.weight"].numpy(), fc1.T)
    assert len(DiT_models) == 12
    assert set(DiT_models) == {f"DiT-{s}/{p}" for s in ("XL", "L", "B", "S") for p in (2, 4, 8)}
    xl = create_dit("DiT-XL/2", device="meta")
    assert (xl.depth, xl.hidden_size, xl.num_heads, xl.head_dim, xl.out_channels) == (28, 1152, 16, 72, 8)
    assert xl.blocks[0].ffn.fc1.out_features == 4608 and not xl.blocks[0].attn.use_rope
    s4 = DiT_models["DiT-S/4"](num_classes=NUM_CLASSES, device="cpu")
    assert (s4.depth, s4.hidden_size, s4.patch_size, s4.y_embedder.table.num_embeddings) == (12, 384, 4, 11)


def test_create_dit_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("there is a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_dit("DiT-S/8")
    assert next(create_dit("DiT-S/8", device="cpu").parameters()).device.type == "cpu"


@pytest.mark.parametrize("loop,clip", [("ddpm", True), ("ddpm", False), ("ddim", False)], ids=["ddpm-clip", "ddpm", "ddim"])
def test_dit_sampling_loops_match_fit_tpu(dit_params, loop, clip):
    """DiT samples through the diffusion loops with forward_with_cfg bound to
    its labels and scale (LEARNED_RANGE: learn_sigma=True), z and the step
    noise injected into both."""
    _, params = dit_params
    steps, scale = 4, 4.0
    rng = np.random.default_rng(3)
    z = rng.normal(size=(2, C, SIDE, SIDE)).astype(np.float32)
    noise = rng.normal(size=(steps, 4, C, SIDE, SIDE)).astype(np.float32)
    y = np.array([3, 7, NUM_CLASSES, NUM_CLASSES], np.int32)
    x_T = np.concatenate([z, z])
    jm = jax_dit("xla")

    def j_fn(x, t):
        return jm.apply(params, x, t, jnp.asarray(y), scale, method=JaxDiT.forward_with_cfg)

    model = port_dit(params)

    def t_fn(x, t):
        return model.forward_with_cfg(x, t, torch.from_numpy(y).long(), scale)

    jd, td = j_create_diffusion(str(steps), learn_sigma=True), create_diffusion(str(steps), learn_sigma=True)
    kw = dict(clip_denoised=clip, return_trajectory=True)
    if loop == "ddpm":
        want = j_p_loop(jd, j_fn, jnp.asarray(x_T), step_noise=jnp.asarray(noise), **kw)
        with torch.no_grad():
            got = p_sample_loop(td, t_fn, torch.from_numpy(x_T), step_noise=torch.from_numpy(noise), **kw)
    else:
        want = j_ddim_loop(jd, j_fn, jnp.asarray(x_T), **kw)
        with torch.no_grad():
            got = ddim_sample_loop(td, t_fn, torch.from_numpy(x_T), **kw)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape == (steps, 4, C, SIDE, SIDE) and np.isfinite(got).all()
    if clip:
        assert np.abs(want).max() < 10
    np.testing.assert_allclose(got, want, atol=1e-4 if clip else 2e-6 * float(np.abs(want).max()), rtol=0)


# --- FiT with pos_kind="absolute" and ffn="mlp" ----------------------------


def fit_inputs(valid, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.normal(size=(2, T, P * P * C)).astype(np.float32)
    pos = np.zeros((2, T, HID), np.float32)
    mask = np.zeros((2, T), bool)
    for i, n in enumerate(valid):
        pos[i, :n] = sincos_2d(HID, 8, 8)[:n]
        mask[i, :n] = True
    t = rng.integers(0, 1000, size=(2,)).astype(np.int32)
    y = rng.integers(0, NUM_CLASSES, size=(2,)).astype(np.int32)
    return tokens, t, y, pos, mask


@pytest.mark.parametrize("backend", ["xla", "flash"])
@pytest.mark.parametrize("valid", [(64, 64), (48, 21)], ids=["full", "padded"])
def test_fit_absolute_mlp_matches_flax(backend, valid):
    tokens, t, y, pos, mask = fit_inputs(valid, seed=len(backend) + valid[1])
    jm = JaxFiT(
        patch_size=P, in_channels=C, hidden_size=HID, depth=DEPTH, num_heads=HEADS, num_classes=NUM_CLASSES,
        class_dropout_prob=0.0, attn_backend=backend, pos_kind="absolute", ffn="mlp",
    )
    args = [jnp.asarray(a) for a in (tokens, t, y, pos, mask)]
    params = randomise(jm.init({"params": jax.random.PRNGKey(0)}, *args, train=True), 6)
    want = np.asarray(jm.apply(params, *args, train=True))
    model = FiT(
        patch_size=P, in_channels=C, hidden_size=HID, depth=DEPTH, num_heads=HEADS, num_classes=NUM_CLASSES,
        class_dropout_prob=0.0, pos_kind="absolute", ffn="mlp",
    )
    model.load_state_dict(torch_state_dict_from_flax(jax.tree.map(np.asarray, params), DEPTH))
    assert model.config["pos_kind"] == "absolute" and model.config["ffn"] == "mlp"
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (tokens, t, y, pos, mask)), train=True).numpy()
    for i, n in enumerate(valid):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=ATOL, rtol=0)


def test_fit_options_that_are_not_ported_raise():
    with pytest.raises(ValueError, match=r"item 9\)"):
        FiT(hidden_size=HID, depth=1, num_heads=HEADS, ffn="moe")
    with pytest.raises(ValueError, match="pos_kind"):
        FiT(hidden_size=HID, depth=1, num_heads=HEADS, pos_kind="learned")
    from fit_tpu_torch.sampling import FiTSampler

    for model in (FiT(hidden_size=HID, depth=1, num_heads=HEADS, pos_kind="absolute"), torch_dit()):
        with pytest.raises(ValueError, match="pos_kind='rotate'"):
            FiTSampler(model, device="cpu")
