"""fit_tpu_torch sampling against fit_tpu on injected randomness.

jax.random and torch generators never agree, so the initial noise ``z`` and
the per-step noise ``step_noise`` are made with numpy and handed to both.

Tolerances: the sampler loops run the same elementwise fp32 arithmetic on
the same fp32 coefficients, so their per-step latents agree to 1e-4 (the
only differences are the order XLA fuses multiplies in). The FiTSampler
runs add the fp32 forward of a random-weight model (3e-5 per forward, see
test_torch_port_model.py) amplified by the x0 prediction's
1/sqrt(alpha_bar) (up to ~160 at t=999), so their latents reach a few
hundred, where one fp32 ulp is ~6e-5; they are compared at 1e-4 or 2e-6 of
the latents' largest magnitude (about 16 ulp), whichever is larger.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fit_tpu.diffusion import create_diffusion as j_create_diffusion
from fit_tpu.diffusion import ddim_sample_loop as j_ddim_loop
from fit_tpu.diffusion import p_sample_loop as j_p_loop
from fit_tpu.models import FiT as JaxFiT
from fit_tpu.sampling import FiTSampler as JaxSampler
from fit_tpu_torch.diffusion.gaussian import create_diffusion
from fit_tpu_torch.diffusion.samplers import ddim_sample_loop, p_sample_loop
from fit_tpu_torch.models.fit import FiT
from fit_tpu_torch.models.from_jax import torch_state_dict_from_flax
from fit_tpu_torch.sampling import FiTSampler

STEPS = 5


# A toy denoiser whose eps is close to x (right for x ~ N(0, 1) at large t),
# so every step's latents stay of order 1 and 1e-4 is a real bound.
def j_model_fn(x, t):
    return 0.9 * x + 0.1 * jnp.tanh(x) + 1e-4 * t.astype(jnp.float32)[:, None, None, None]


def t_model_fn(x, t):
    return 0.9 * x + 0.1 * torch.tanh(x) + 1e-4 * t.float()[:, None, None, None]


@pytest.mark.parametrize(
    "loop,eta", [("ddpm", None), ("ddim", 0.0), ("ddim", 0.5)], ids=["ddpm", "ddim", "ddim-eta"]
)
@pytest.mark.parametrize("learn_sigma", [False, True])
def test_sampler_loops_match_per_step(loop, eta, learn_sigma):
    rng = np.random.default_rng(0)
    x_T = rng.normal(size=(2, 4, 8, 8)).astype(np.float32)
    noise = rng.normal(size=(STEPS, 2, 4, 8, 8)).astype(np.float32)
    jd = j_create_diffusion(str(STEPS), learn_sigma=learn_sigma)
    td = create_diffusion(str(STEPS), learn_sigma=learn_sigma)
    assert td.num_timesteps == jd.num_timesteps == STEPS
    np.testing.assert_array_equal(td.timestep_map, jd.timestep_map)

    if learn_sigma:  # the second half of the channels carries the variance
        jf = lambda x, t: jnp.concatenate([j_model_fn(x, t), jnp.tanh(x)], axis=1)
        tf = lambda x, t: torch.cat([t_model_fn(x, t), torch.tanh(x)], dim=1)
    else:
        jf, tf = j_model_fn, t_model_fn
    kw = dict(clip_denoised=False, return_trajectory=True)
    if loop == "ddpm":
        want = j_p_loop(jd, jf, jnp.asarray(x_T), step_noise=jnp.asarray(noise), **kw)
        got = p_sample_loop(td, tf, torch.from_numpy(x_T), step_noise=torch.from_numpy(noise), **kw)
    else:
        want = j_ddim_loop(jd, jf, jnp.asarray(x_T), eta=eta, step_noise=jnp.asarray(noise), **kw)
        got = ddim_sample_loop(
            td, tf, torch.from_numpy(x_T), eta=eta, step_noise=torch.from_numpy(noise), **kw
        )
    assert got.shape == want.shape == (STEPS, 2, 4, 8, 8)
    assert np.abs(np.asarray(want)).max() < 10
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_clip_denoised_and_generator_noise():
    td = create_diffusion("3")
    x = torch.randn(2, 4, 4, 4, generator=torch.Generator().manual_seed(0))
    a = p_sample_loop(td, t_model_fn, x, torch.Generator().manual_seed(1))
    b = p_sample_loop(td, t_model_fn, x, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    out = td.p_mean_variance(t_model_fn, x * 100, torch.full((2,), 2), clip_denoised=True)
    assert out["pred_xstart"].abs().max() <= 1


@pytest.fixture(scope="module")
def tiny_models():
    jm = JaxFiT(
        patch_size=2, in_channels=4, hidden_size=96, depth=2, num_heads=6,
        num_classes=10, attn_backend="xla",
    )
    params = jm.init(
        {"params": jax.random.PRNGKey(0), "label_dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 8, 16)), jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 8, 16)), jnp.ones((1, 8), bool), train=True,
    )
    leaves, td = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    params = jax.tree.unflatten(
        td, [0.02 * jax.random.normal(k, l.shape, l.dtype) for k, l in zip(keys, leaves)]
    )
    tm = FiT(patch_size=2, in_channels=4, hidden_size=96, depth=2, num_heads=6, num_classes=10)
    tm.load_state_dict(torch_state_dict_from_flax(jax.tree.map(np.asarray, params), 2))
    return jm, params, tm


def assert_latents_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    atol = max(1e-4, 2e-6 * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


SAMPLER_KW = dict(num_sampling_steps=4, cfg_scale=1.5, max_size=16, max_length=64, num_classes=10)
TORCH_KW = dict(SAMPLER_KW, device="cpu")  # the port runs on the card unless asked


def test_fit_sampler_sample_matches_jax(tiny_models):
    jm, params, tm = tiny_models
    z = np.random.default_rng(3).normal(size=(2, 4, 12, 20)).astype(np.float32)
    want = JaxSampler(jm, sampler="ddim", **SAMPLER_KW).sample(
        params, [1, 2], jax.random.PRNGKey(0), 96, 160, z=jnp.asarray(z)
    )
    got = FiTSampler(tm, sampler="ddim", **TORCH_KW).sample([1, 2], 96, 160, z=torch.from_numpy(z))
    assert got.shape == (2, 4, 12, 20)
    assert_latents_close(got.numpy(), want)


@pytest.mark.parametrize("height,width", [(128, 192), (192, 192)], ids=["T96", "T144"])
def test_fit_sampler_sample_past_the_token_budget_matches_jax(tiny_models, height, width):
    """Past the 64-token budget the sequence grows to the size's own token
    count (T = 96, 144) and RoPE switches to VisionNTK; the key loop then
    runs over more keys than the budget."""
    jm, params, tm = tiny_models
    h, w = height // 8, width // 8
    z = np.random.default_rng(5).normal(size=(2, 4, h, w)).astype(np.float32)
    want = JaxSampler(jm, sampler="ddim", **SAMPLER_KW).sample(
        params, [6, 7], jax.random.PRNGKey(0), height, width, z=jnp.asarray(z)
    )
    got = FiTSampler(tm, sampler="ddim", **TORCH_KW).sample([6, 7], height, width, z=torch.from_numpy(z))
    assert got.shape == (2, 4, h, w) and (h // 2) * (w // 2) > SAMPLER_KW["max_length"]
    assert_latents_close(got.numpy(), want)


def test_fit_sampler_sample_mixed_matches_jax(tiny_models):
    jm, params, tm = tiny_models
    sizes = [(128, 128), (96, 160), (64, 96)]
    z = np.random.default_rng(4).normal(size=(3, 4, 16, 16)).astype(np.float32)
    want = JaxSampler(jm, sampler="ddim", **SAMPLER_KW).sample_mixed(
        params, [3, 4, 5], sizes, jax.random.PRNGKey(0), z=jnp.asarray(z)
    )
    got = FiTSampler(tm, sampler="ddim", **TORCH_KW).sample_mixed(
        [3, 4, 5], sizes, z=torch.from_numpy(z)
    )
    assert [tuple(g.shape) for g in got] == [(4, 16, 16), (4, 12, 20), (4, 8, 12)]
    for g, w in zip(got, want):
        assert_latents_close(g.numpy(), w)


def test_fit_sampler_ddpm_and_bf16_run(tiny_models):
    _, _, tm = tiny_models
    model = FiT(patch_size=2, in_channels=4, hidden_size=96, depth=2, num_heads=6,
                num_classes=10, dtype=torch.bfloat16)
    model.load_state_dict(tm.state_dict())
    s = FiTSampler(model, sampler="ddpm", **TORCH_KW)
    assert next(model.parameters()).dtype == torch.bfloat16  # cast once, in place
    out = s.sample([0, 9], 128, 128, generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, 4, 16, 16) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="token budget"):
        s.sample_mixed([0], [(256, 256)])


def test_zero_length_row_raises_from_the_sampler(tiny_models):
    """The sampler checks its masks on the host (no device read-back in the
    denoise loop); a size with no token still fails before any forward, and
    a device mask handed to the model is still checked there."""
    _, _, tm = tiny_models
    s = FiTSampler(tm, sampler="ddim", **TORCH_KW)
    with pytest.raises(ValueError, match="at least one valid token"):
        s.sample_mixed([1, 2], [(128, 128), (0, 128)])
    with pytest.raises(ValueError, match="at least one valid token"):
        s.sample([1], 0, 128)
    x = torch.zeros((2, 4, 16, 16))
    mask = torch.zeros((2, 64), dtype=torch.bool)
    mask[0, :10] = True
    with pytest.raises(ValueError, match="at least one valid token"):
        tm(x, torch.zeros(2), torch.zeros(2, dtype=torch.long), torch.zeros((2, 64, 16)), mask, train=False)


def test_port_never_imports_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import importlib, pkgutil, fit_tpu_torch\n"
        "for m in pkgutil.walk_packages(fit_tpu_torch.__path__, 'fit_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k == 'fit_tpu' or k.startswith(('fit_tpu.', 'flax')) for k in sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
