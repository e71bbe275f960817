"""fit_tpu_torch's schedules, diffusion options, hooks, reverse DDIM, CFG
wrapper and DPM-Solver++ against fit_tpu's, on numpy-seeded inputs.

Tolerances:
- beta schedules and coefficient tables: byte-equal (the same fp64 numpy).
- One diffusion step (``p_mean_variance``, ``p_sample``, ``ddim_sample``,
  ``ddim_reverse_sample``), the loops and the CFG wrapper: the same fp32
  elementwise arithmetic on the same fp32 coefficients; XLA may fuse a
  multiply-add into one rounding, so values agree to 1e-5 relative to the
  largest magnitude of the step (a few fp32 ulps), 1e-4 for loops.
- DPM-Solver++: fp32 scalars from the same tables, with ``expm1`` and
  ``1/(2r)`` rounded by numpy here and by XLA there: 1e-4 on latents of
  order 1, per step and at the end.
- ``FiTSampler(sampler="dpm")``: the latent bar of the sampler tests,
  ``max(1e-4, 2e-6 * max|latent|)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fit_tpu.core.schedules as jsch
from fit_tpu.diffusion import create_diffusion as j_create_diffusion
from fit_tpu.diffusion import dpm_solver_pp_2m as j_dpm
from fit_tpu.diffusion.samplers import cfg_model_fn as j_cfg_model_fn
from fit_tpu.diffusion.samplers import ddim_reverse_loop as j_reverse_loop
from fit_tpu.diffusion.samplers import ddim_sample_loop as j_ddim_loop
from fit_tpu.diffusion.samplers import p_sample_loop as j_p_loop
from fit_tpu.models import FiT as JaxFiT
from fit_tpu.sampling import FiTSampler as JaxSampler
import fit_tpu_torch.core.schedules as tsch
from fit_tpu_torch.diffusion.dpm_solver import dpm_solver_pp_2m
from fit_tpu_torch.diffusion.gaussian import create_diffusion
from fit_tpu_torch.diffusion.samplers import cfg_model_fn, ddim_reverse_loop, ddim_sample_loop, p_sample_loop
from fit_tpu_torch.models.fit import FiT
from fit_tpu_torch.models.from_jax import torch_state_dict_from_flax
from fit_tpu_torch.sampling import FiTSampler
from fit_tpu_torch.serve import SamplingServer

SHAPE = (2, 4, 8, 8)
STEPS = 6


def _byte_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["quad", "linear", "warmup10", "warmup50", "const", "jsd"])
@pytest.mark.parametrize("steps", [10, 1000])
def test_beta_schedule_shapes_byte_equal(name, steps):
    kw = dict(beta_start=1e-4, beta_end=0.02, num_steps=steps)
    _byte_equal(tsch.beta_schedule(name, **kw), jsch.beta_schedule(name, **kw))


def test_unknown_schedules_raise():
    with pytest.raises(ValueError, match="unknown beta schedule shape"):
        tsch.beta_schedule("cubic", beta_start=1e-4, beta_end=0.02, num_steps=4)
    with pytest.raises(ValueError, match="unknown beta schedule"):
        tsch.named_beta_schedule("quad", 10)


OPTIONS = {
    "fixed-large": {},
    "fixed-small": dict(sigma_small=True),
    "start-x": dict(predict_xstart=True),
    "start-x-small": dict(predict_xstart=True, sigma_small=True),
    "learn-sigma-start-x": dict(learn_sigma=True, predict_xstart=True),
    "cosine": dict(noise_schedule="squaredcos_cap_v2", sigma_small=True),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_create_diffusion_tables_equal(option):
    jd = j_create_diffusion("25", **OPTIONS[option])
    td = create_diffusion("25", **OPTIONS[option])
    np.testing.assert_array_equal(td.timestep_map, jd.timestep_map)
    assert td.original_num_steps == jd.original_num_steps
    for field in ("betas", "alphas_cumprod", "posterior_variance", "posterior_log_variance_clipped",
                  "fixed_large_variance", "alphas_cumprod_next"):
        _byte_equal(getattr(td.c, field), getattr(jd.c, field))


@pytest.mark.parametrize("kw", [dict(use_kl=True), dict(rescale_learned_sigmas=True)], ids=["use_kl", "rescaled"])
def test_vlb_losses_raise(kw):
    """The VLB loss options build fit_tpu's process: the same loss type and
    tables, respaced, and the same loss terms on the same inputs (each
    term within 1e-5 relative)."""
    kw = dict(kw, learn_sigma=True)
    jd, td = j_create_diffusion("10", **kw), create_diffusion("10", **kw)
    assert td.loss_type.name == jd.loss_type.name
    np.testing.assert_array_equal(td.timestep_map, jd.timestep_map)
    _byte_equal(td.c.posterior_log_variance_clipped, jd.c.posterior_log_variance_clipped)
    rng = np.random.default_rng(3)
    x0, noise = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(2))
    t = np.array([0, 7], np.int32)
    got = td.training_losses(t_model(True), torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(noise))
    want = jd.training_losses(j_model(True), jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)


# A toy model: its output depends on x and t and stays of order 1; with
# learn_sigma a second half of channels carries the variance values.
def j_model(learn_sigma):
    def f(x, t):
        out = 0.9 * x + 0.1 * jnp.tanh(x) + 1e-4 * t.astype(jnp.float32)[:, None, None, None]
        return jnp.concatenate([out, jnp.tanh(x)], axis=1) if learn_sigma else out
    return f


def t_model(learn_sigma):
    def f(x, t):
        out = 0.9 * x + 0.1 * torch.tanh(x) + 1e-4 * t.float()[:, None, None, None]
        return torch.cat([out, torch.tanh(x)], dim=1) if learn_sigma else out
    return f


HOOKS = {
    "none": (None, None, None, None),
    "denoised": (lambda x0: 0.5 * jnp.tanh(x0), None, lambda x0: 0.5 * torch.tanh(x0), None),
    "cond": (None, lambda x, t: -0.3 * x, None, lambda x, t: -0.3 * x),
    "both": (lambda x0: 0.5 * jnp.tanh(x0), lambda x, t: -0.3 * x,
             lambda x0: 0.5 * torch.tanh(x0), lambda x, t: -0.3 * x),
}


def assert_step_close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=rel * max(1.0, float(np.abs(want).max())), rtol=0)


@pytest.mark.parametrize("hooks", list(HOOKS))
@pytest.mark.parametrize("option", ["fixed-small", "start-x", "learn-sigma-start-x"])
@pytest.mark.parametrize("t_value", [0, 3, 9])
def test_single_steps_match_jax(option, hooks, t_value):
    jd = j_create_diffusion("10", **OPTIONS[option])
    td = create_diffusion("10", **OPTIONS[option])
    ls = OPTIONS[option].get("learn_sigma", False)
    j_den, j_cond, t_den, t_cond = HOOKS[hooks]
    rng = np.random.default_rng(t_value)
    x = rng.normal(size=SHAPE).astype(np.float32)
    noise = rng.normal(size=SHAPE).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jt, tt = jnp.full((2,), t_value), torch.full((2,), t_value)
    jf, tf = j_model(ls), t_model(ls)

    want = jd.p_mean_variance(jf, jx, jt, clip_denoised=True, denoised_fn=j_den)
    got = td.p_mean_variance(tf, tx, tt, clip_denoised=True, denoised_fn=t_den)
    for k in ("mean", "variance", "log_variance", "pred_xstart"):
        assert_step_close(np.broadcast_to(got[k].numpy(), SHAPE), np.broadcast_to(np.asarray(want[k]), SHAPE))

    want = jd.p_sample(jf, jx, jt, jnp.asarray(noise), denoised_fn=j_den, cond_fn=j_cond)["sample"]
    got = td.p_sample(tf, tx, tt, torch.from_numpy(noise), denoised_fn=t_den, cond_fn=t_cond)["sample"]
    assert_step_close(got.numpy(), want)

    for eta in (0.0, 0.5):
        want = jd.ddim_sample(jf, jx, jt, jnp.asarray(noise), denoised_fn=j_den, cond_fn=j_cond, eta=eta)
        got = td.ddim_sample(tf, tx, tt, torch.from_numpy(noise), denoised_fn=t_den, cond_fn=t_cond, eta=eta)
        assert_step_close(got["sample"].numpy(), want["sample"])
        assert_step_close(got["pred_xstart"].numpy(), want["pred_xstart"])

    want = jd.ddim_reverse_sample(jf, jx, jt, clip_denoised=False, denoised_fn=j_den, cond_fn=j_cond)
    got = td.ddim_reverse_sample(tf, tx, tt, clip_denoised=False, denoised_fn=t_den, cond_fn=t_cond)
    assert_step_close(got["sample"].numpy(), want["sample"])


@pytest.mark.parametrize("loop", ["ddpm", "ddim"])
@pytest.mark.parametrize("option", ["fixed-small", "start-x"])
def test_loops_with_hooks_match_jax(loop, option):
    jd = j_create_diffusion(str(STEPS), **OPTIONS[option])
    td = create_diffusion(str(STEPS), **OPTIONS[option])
    j_den, j_cond, t_den, t_cond = HOOKS["both"]
    rng = np.random.default_rng(1)
    x = rng.normal(size=SHAPE).astype(np.float32)
    noise = rng.normal(size=(STEPS,) + SHAPE).astype(np.float32)
    kw = dict(clip_denoised=False, return_trajectory=True)
    if loop == "ddpm":
        want = j_p_loop(jd, j_model(False), jnp.asarray(x), denoised_fn=j_den, cond_fn=j_cond,
                        step_noise=jnp.asarray(noise), **kw)
        got = p_sample_loop(td, t_model(False), torch.from_numpy(x), denoised_fn=t_den, cond_fn=t_cond,
                            step_noise=torch.from_numpy(noise), **kw)
    else:
        want = j_ddim_loop(jd, j_model(False), jnp.asarray(x), denoised_fn=j_den, cond_fn=j_cond,
                           eta=0.5, step_noise=jnp.asarray(noise), **kw)
        got = ddim_sample_loop(td, t_model(False), torch.from_numpy(x), denoised_fn=t_den, cond_fn=t_cond,
                               eta=0.5, step_noise=torch.from_numpy(noise), **kw)
    assert got.shape == (STEPS,) + SHAPE
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_ddim_reverse_loop_matches_jax():
    jd, td = j_create_diffusion("20"), create_diffusion("20")
    x0 = np.random.default_rng(2).normal(size=SHAPE).astype(np.float32) * 0.5
    want = j_reverse_loop(jd, lambda x, t: 0.05 * x + 0.3, jnp.asarray(x0), denoised_fn=lambda v: 0.9 * v)
    got = ddim_reverse_loop(td, lambda x, t: 0.05 * x + 0.3, torch.from_numpy(x0), denoised_fn=lambda v: 0.9 * v)
    assert got.shape == SHAPE and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4 * max(1.0, float(np.abs(want).max())))


def test_cfg_model_fn_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 4, 8, 8)).astype(np.float32)
    t = np.array([5, 5, 5, 5])
    w = rng.normal(size=(8, 4)).astype(np.float32)

    def j_apply(v, tt):  # 8 channels out, label-free but batch-position dependent
        out = jnp.einsum("oc,bchw->bohw", jnp.asarray(w), v)
        return out * (1.0 + 0.1 * jnp.arange(v.shape[0])[:, None, None, None]) + 1e-3 * tt[:, None, None, None]

    def t_apply(v, tt):
        out = torch.einsum("oc,bchw->bohw", torch.from_numpy(w), v)
        return out * (1.0 + 0.1 * torch.arange(v.shape[0])[:, None, None, None]) + 1e-3 * tt[:, None, None, None]

    want = j_cfg_model_fn(j_apply, 2.5)(jnp.asarray(x), jnp.asarray(t))
    got = cfg_model_fn(t_apply, 2.5)(torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == (4, 8, 8, 8)
    torch.testing.assert_close(got[:2, :4], got[2:, :4], rtol=0, atol=0)
    assert_step_close(got.numpy(), want)


@pytest.mark.parametrize("kind", ["eps", "start-x", "learn-sigma"])
def test_dpm_solver_matches_jax(kind):
    opts = {"eps": {}, "start-x": dict(predict_xstart=True), "learn-sigma": dict(learn_sigma=True)}[kind]
    jd, td = j_create_diffusion("12", **opts), create_diffusion("12", **opts)
    x = np.random.default_rng(4).normal(size=SHAPE).astype(np.float32)
    ls = kind == "learn-sigma"
    want = np.asarray(j_dpm(jd, j_model(ls), jnp.asarray(x)))
    got = dpm_solver_pp_2m(td, t_model(ls), torch.from_numpy(x)).numpy()
    assert got.shape == SHAPE and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_dpm_solver_computes_no_nan_at_the_last_step():
    """The last step (from step 0) has h = 0; the port takes x0 there
    without computing the 2M ratio, so nothing non-finite appears even in
    a model output traced through every step."""
    td = create_diffusion("5")
    seen = []

    def model(x, t):
        seen.append(torch.isfinite(x).all().item())
        return 0.1 * x

    out = dpm_solver_pp_2m(td, model, torch.randn(SHAPE, generator=torch.Generator().manual_seed(0)))
    assert torch.isfinite(out).all() and len(seen) == 5 and all(seen)


def test_dpm_solver_exact_for_constant_x0():
    """The port of tests/test_diffusion.py's check: a model whose x0
    prediction is constant c lands on c."""
    diff = create_diffusion("20")
    c = -0.21
    sr = torch.from_numpy(diff.c.sqrt_recip_alphas_cumprod.astype(np.float32))
    srm1 = torch.from_numpy(diff.c.sqrt_recipm1_alphas_cumprod.astype(np.float32))
    inv = torch.zeros(diff.original_num_steps, dtype=torch.long)
    for i, orig in enumerate(diff.timestep_map):
        inv[orig] = i

    def model_fn(x, t_orig):
        tl = inv[t_orig].reshape(-1, 1, 1, 1)
        return (sr[tl] * x - c) / srm1[tl]

    x = torch.from_numpy(np.random.default_rng(6).normal(size=SHAPE).astype(np.float32))
    np.testing.assert_allclose(dpm_solver_pp_2m(diff, model_fn, x).numpy(), c, atol=1e-3)


def test_dpm_solver_converges_faster_than_ddim():
    """At 50 steps the 2nd-order solver lands closer to the 1000-step DDIM
    solution than 1st-order DDIM at 50 steps."""

    def model(x, t):
        return 0.05 * x * (1.0 + 0.001 * t.float().reshape(-1, 1, 1, 1))

    x = torch.from_numpy(np.random.default_rng(7).normal(size=SHAPE).astype(np.float32))
    ref = ddim_sample_loop(create_diffusion(None), model, x, clip_denoised=False).numpy()
    coarse = create_diffusion("50")
    a = ddim_sample_loop(coarse, model, x, clip_denoised=False).numpy()
    b = dpm_solver_pp_2m(coarse, model, x).numpy()
    err_ddim, err_dpm = np.abs(a - ref).mean(), np.abs(b - ref).mean()
    assert err_dpm < err_ddim, (err_dpm, err_ddim)
    assert err_dpm < 0.05 * np.abs(ref).mean(), (err_dpm, np.abs(ref).mean())


# --- FiTSampler and SamplingServer under "dpm" --------------------------------


@pytest.fixture(scope="module")
def tiny_models():
    jm = JaxFiT(patch_size=2, in_channels=4, hidden_size=96, depth=2, num_heads=6,
                num_classes=10, attn_backend="xla")
    params = jm.init(
        {"params": jax.random.PRNGKey(0), "label_dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 8, 16)), jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 8, 16)), jnp.ones((1, 8), bool), train=True,
    )
    leaves, td = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(11), len(leaves))
    params = jax.tree.unflatten(td, [0.02 * jax.random.normal(k, l.shape, l.dtype) for k, l in zip(keys, leaves)])
    tm = FiT(patch_size=2, in_channels=4, hidden_size=96, depth=2, num_heads=6, num_classes=10)
    tm.load_state_dict(torch_state_dict_from_flax(jax.tree.map(np.asarray, params), 2))
    return jm, params, tm


SAMPLER_KW = dict(num_sampling_steps=4, cfg_scale=1.5, max_size=16, max_length=64, num_classes=10)


def assert_latents_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=max(1e-4, 2e-6 * float(np.abs(want).max())), rtol=0)


def test_fit_sampler_dpm_matches_jax(tiny_models):
    jm, params, tm = tiny_models
    z = np.random.default_rng(8).normal(size=(2, 4, 12, 20)).astype(np.float32)
    want = JaxSampler(jm, sampler="dpm", **SAMPLER_KW).sample(
        params, [1, 2], jax.random.PRNGKey(0), 96, 160, z=jnp.asarray(z)
    )
    got = FiTSampler(tm, sampler="dpm", device="cpu", **SAMPLER_KW).sample([1, 2], 96, 160, z=torch.from_numpy(z))
    assert got.shape == (2, 4, 12, 20)
    assert_latents_close(got.numpy(), want)


def test_fit_sampler_dpm_mixed_matches_jax(tiny_models):
    jm, params, tm = tiny_models
    sizes = [(128, 128), (96, 160), (64, 96)]
    z = np.random.default_rng(9).normal(size=(3, 4, 16, 16)).astype(np.float32)
    want = JaxSampler(jm, sampler="dpm", **SAMPLER_KW).sample_mixed(
        params, [3, 4, 5], sizes, jax.random.PRNGKey(0), z=jnp.asarray(z)
    )
    got = FiTSampler(tm, sampler="dpm", device="cpu", **SAMPLER_KW).sample_mixed(
        [3, 4, 5], sizes, z=torch.from_numpy(z)
    )
    for g, w in zip(got, want):
        assert_latents_close(g.numpy(), w)


def test_fit_sampler_rejects_unknown_sampler(tiny_models):
    with pytest.raises(ValueError, match="'ddim', 'ddpm' or 'dpm'"):
        FiTSampler(tiny_models[2], sampler="euler", device="cpu")


def test_served_dpm_seed_is_bit_identical_across_batches(tiny_models):
    """Under "dpm" a seeded request's latent does not depend on what
    shares its batch: alone, then among three others."""
    srv = SamplingServer(tiny_models[2], batch_size=4, max_batch_wait_s=0.05, sampler="dpm", device="cpu",
                         **SAMPLER_KW)
    try:
        alone = srv.submit(3, 128, 128, seed=42).result(timeout=120)
        futs = [srv.submit(1 + i, 96, 128, seed=i) for i in range(3)] + [srv.submit(3, 128, 128, seed=42)]
        shared = [f.result(timeout=120) for f in futs]
    finally:
        srv.close()
    assert alone.shape == (4, 16, 16) and np.isfinite(alone).all()
    np.testing.assert_array_equal(alone, shared[-1])
    assert not np.array_equal(shared[0], shared[1])


@pytest.mark.parametrize("option", ["fixed-large", "start-x"])
def test_training_loss_targets_match_jax(option):
    """The MSE target is eps, or x0 under START_X."""
    jd, td = j_create_diffusion(None, **OPTIONS[option]), create_diffusion(None, **OPTIONS[option])
    rng = np.random.default_rng(12)
    x0, noise = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(2))
    t = np.array([10, 700])
    want = jd.training_losses(j_model(False), jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))["mse"]
    got = td.training_losses(t_model(False), torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(noise))["mse"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
