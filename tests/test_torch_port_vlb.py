"""The Trainer's remaining options against fit_tpu, on the CPU: the
variational-bound (VLB) half of the Gaussian diffusion, and FiT training
with the tanh-GELU MLP blocks (``ffn="mlp"``).

The same numpy-seeded inputs go through fit_tpu's functions and the port's,
fp32 on both sides. Tolerances:
- elementwise terms (``normal_kl``, the log-likelihoods, the CDF): 1e-5
  relative, 1e-6 absolute (the same fp32 formulas; XLA may fuse a
  multiply-add into one rounding, and tanh/exp/log differ by an ulp);
- per-sample means (``vb_terms_bpd``, ``training_losses``,
  ``prior_bpd``): 1e-4 relative, 1e-5 absolute. At t = 0 the bound's term
  is the decoder NLL, the log of a difference of two CDFs near 1, where
  the last bit of a tanh (XLA's and torch's differ there) moves a sample's
  term by up to 5e-5 relative (measured); the other terms agree to 1e-5;
- ``calc_bpd_loop``: 1e-4 relative, 1e-5 absolute on each step's terms and
  the total (a sum over the steps);
- the ``ffn="mlp"`` loss: 1e-5 relative; gradients 1e-4 of each leaf's max
  |g| (the bars of tests/test_torch_port_train.py for SwiGLU).
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fit_tpu.core.pos_embed import rope_freqs_2d
from fit_tpu.diffusion import create_diffusion as j_create_diffusion
from fit_tpu.diffusion import gaussian as jg
from fit_tpu.models import FiT as JaxFiT
from fit_tpu.train.step import diffusion_loss as jax_diffusion_loss
from fit_tpu_torch.diffusion import gaussian as tg
from fit_tpu_torch.diffusion.gaussian import LossType, create_diffusion
from fit_tpu_torch.models.fit import FiT
from fit_tpu_torch.models.from_jax import torch_state_dict_from_flax
from fit_tpu_torch.models.layers import GeluMlp
from fit_tpu_torch.train.loop import Trainer
from fit_tpu_torch.train.step import diffusion_loss
from fit_tpu_torch.utils.config import TrainConfig

SHAPE = (3, 4, 6, 6)
ELEM = dict(rtol=1e-5, atol=1e-6)
MEAN = dict(rtol=1e-4, atol=1e-5)
T, P, C = 64, 2, 4
HID, HEADS, DEPTH = 96, 6, 2
NUM_CLASSES = 10
WAIT_S = 300  # the longest a Trainer run here may take


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), **(tol or ELEM))


def inputs(seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    x0 = np.clip(rng.normal(size=shape), -1, 1).astype(np.float32)
    x0.reshape(-1)[:8] = [-1, 1, -0.9995, 0.9995, -1, 1, 0, 0.5]  # both open-ended bins of the decoder NLL
    noise = rng.normal(size=shape).astype(np.float32)
    return x0, noise


# A toy model over axis 1: the mean half depends on x and t, the variance
# half (learn_sigma) on x alone, both of order 1.
def j_model(x, t):
    out = 0.9 * x + 0.1 * jnp.tanh(x) + 1e-4 * t.astype(jnp.float32).reshape((-1,) + (1,) * (x.ndim - 1))
    return jnp.concatenate([out, jnp.tanh(0.7 * x)], axis=1)


def t_model(x, t):
    out = 0.9 * x + 0.1 * torch.tanh(x) + 1e-4 * t.float().reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.cat([out, torch.tanh(0.7 * x)], dim=1)


def test_normal_kl_and_log_likelihoods_match():
    rng = np.random.default_rng(1)
    a, b, la, lb = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(4))
    x, _ = inputs(2)
    ta, tb, tla, tlb, tx = (torch.from_numpy(v) for v in (a, b, la, lb, x))
    close(tg.normal_kl(ta, tla, tb, tlb), jg.normal_kl(a, la, b, lb))
    close(tg.normal_kl(ta, tla, 0.0, 0.0), jg.normal_kl(a, la, 0.0, 0.0))
    close(tg.approx_standard_normal_cdf(ta), jg.approx_standard_normal_cdf(jnp.asarray(a)))
    close(tg.continuous_gaussian_log_likelihood(tx, means=tb, log_scales=0.3 * tlb),
          jg.continuous_gaussian_log_likelihood(jnp.asarray(x), means=jnp.asarray(b), log_scales=0.3 * jnp.asarray(lb)))
    # means within a few bins of x at the scales of the schedule's variances: there
    # the difference of the two CDFs is well conditioned in fp32
    means, log_scales = x + 0.02 * b, 0.1 * lb - 3.0
    close(tg.discretized_gaussian_log_likelihood(tx, means=torch.from_numpy(means), log_scales=torch.from_numpy(log_scales)),
          jg.discretized_gaussian_log_likelihood(jnp.asarray(x), means=jnp.asarray(means), log_scales=jnp.asarray(log_scales)))


@pytest.mark.parametrize("layout", ["images", "tokens-masked"])
def test_vb_terms_bpd_matches(layout):
    """The bound's term at t = 0 (the decoder NLL) and t > 0 (the KL), with
    LEARNED_RANGE variance; on (N, T, D) tokens with a prefix mask too."""
    shape, mask = SHAPE, None
    if layout != "images":
        shape = (3, 10, 8)
        mask = np.arange(10)[None] < np.array([10, 4, 1])[:, None]
    x0, noise = inputs(3, shape)
    t = np.array([0, 17, 999], np.int32)
    jd, td = j_create_diffusion(None, learn_sigma=True), create_diffusion(None, learn_sigma=True)
    j_xt = jd.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    tt = torch.from_numpy(t)
    t_xt = td.q_sample(torch.from_numpy(x0), tt, torch.from_numpy(noise))
    for clip in (True, False):
        want = jd.vb_terms_bpd(j_model, jnp.asarray(x0), j_xt, jnp.asarray(t), clip,
                               mask=None if mask is None else jnp.asarray(mask))
        got = td.vb_terms_bpd(t_model, torch.from_numpy(x0), t_xt, tt, clip,
                              mask=None if mask is None else torch.from_numpy(mask))
        close(got["output"], want["output"], **MEAN)
        close(got["pred_xstart"], want["pred_xstart"])


LOSSES = {
    "learn_sigma-mse": dict(learn_sigma=True),
    "learn_sigma-rescaled_mse": dict(learn_sigma=True, rescale_learned_sigmas=True),
    "rescaled_kl": dict(use_kl=True),
    "learn_sigma-rescaled_kl": dict(use_kl=True, learn_sigma=True),
    "learn_sigma-start_x-respaced": dict(learn_sigma=True, predict_xstart=True, timestep_respacing="50"),
}


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("option", list(LOSSES))
def test_training_losses_match(option, masked):
    kw = dict(LOSSES[option])
    respacing = kw.pop("timestep_respacing", None)
    jd, td = j_create_diffusion(respacing, **kw), create_diffusion(respacing, **kw)
    assert td.loss_type.name == jd.loss_type.name
    shape = (3, 10, 8)
    x0, noise = inputs(4, shape)
    mask = np.arange(10)[None] < np.array([10, 6, 2])[:, None] if masked else None
    t = np.array([0, 3, td.num_timesteps - 1], np.int32)
    learn_sigma = kw.get("learn_sigma", False)
    jm = j_model if learn_sigma else (lambda x, tt: j_model(x, tt)[:, : x.shape[1]])
    tm = t_model if learn_sigma else (lambda x, tt: t_model(x, tt)[:, : x.shape[1]])
    want = jd.training_losses(jm, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise),
                              None if mask is None else jnp.asarray(mask))
    got = td.training_losses(tm, torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(noise),
                             None if mask is None else torch.from_numpy(mask))
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], **MEAN)


def test_prior_bpd_matches():
    x0, _ = inputs(5)
    for respacing in (None, "25"):
        close(create_diffusion(respacing).prior_bpd(torch.from_numpy(x0)),
              j_create_diffusion(respacing).prior_bpd(jnp.asarray(x0)), **MEAN)


def jax_bpd_noise(rng, n_steps, shape):
    """The noise fit_tpu's calc_bpd_loop draws at each timestep, indexed by t."""
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng, ti), shape, jnp.float32))
                     for ti in range(n_steps)])


@pytest.mark.parametrize("respacing", ["8", "12"])
def test_calc_bpd_loop_matches_on_the_same_noise(respacing):
    """The whole bound over a respaced process (the model sees the base
    timesteps), the per-step noise fit_tpu draws injected."""
    x0, _ = inputs(6)
    jd, td = j_create_diffusion(respacing, learn_sigma=True), create_diffusion(respacing, learn_sigma=True)
    rng = jax.random.PRNGKey(9)
    want = jd.calc_bpd_loop(j_model, jnp.asarray(x0), rng)
    got = td.calc_bpd_loop(t_model, torch.from_numpy(x0), noise=torch.from_numpy(jax_bpd_noise(rng, td.num_timesteps, SHAPE)))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        close(got[k], want[k], rtol=1e-4, atol=1e-5)


def test_calc_bpd_loop_draws_from_the_generator():
    x0, _ = inputs(7)
    td = create_diffusion("4", learn_sigma=True)

    def run(seed):
        return td.calc_bpd_loop(t_model, torch.from_numpy(x0), generator=torch.Generator().manual_seed(seed))

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a["total_bpd"], b["total_bpd"]) and not torch.equal(a["mse"], c["mse"])
    assert torch.isfinite(a["total_bpd"]).all() and a["vb"].shape == (SHAPE[0], 4)


@pytest.mark.parametrize("rescaled", [False, True], ids=["mse", "rescaled_mse"])
def test_vb_gradient_reaches_only_the_variance_half(rescaled):
    """vb trains the variance half alone; mse the mean half alone."""
    td = create_diffusion(None, learn_sigma=True, rescale_learned_sigmas=rescaled)
    x0, noise = inputs(8)
    out = torch.from_numpy(np.random.default_rng(0).normal(size=(SHAPE[0], 2 * SHAPE[1]) + SHAPE[2:])
                           .astype(np.float32)).requires_grad_()
    t = torch.tensor([0, 400, 999])
    terms = td.training_losses(lambda *_: out, torch.from_numpy(x0), t, torch.from_numpy(noise))
    (g_vb,) = torch.autograd.grad(terms["vb"].sum(), out, retain_graph=True)
    (g_mse,) = torch.autograd.grad(terms["mse"].sum(), out)
    c = SHAPE[1]
    assert torch.count_nonzero(g_vb[:, :c]) == 0 and torch.count_nonzero(g_vb[:, c:]) > 0
    assert torch.count_nonzero(g_mse[:, c:]) == 0 and torch.count_nonzero(g_mse[:, :c]) > 0


def test_create_diffusion_loss_types():
    assert create_diffusion(None).loss_type == LossType.MSE
    assert create_diffusion(None, rescale_learned_sigmas=True).loss_type == LossType.RESCALED_MSE
    assert create_diffusion(None, use_kl=True, rescale_learned_sigmas=True).loss_type == LossType.RESCALED_KL
    assert LossType.RESCALED_KL.is_vb() and LossType.KL.is_vb() and not LossType.RESCALED_MSE.is_vb()


# --- ffn="mlp" training --------------------------------------------------------


def make_batch(b, seed):
    rng = np.random.default_rng(seed)
    valid = rng.integers(20, T + 1, size=b)
    head_dim = HID // HEADS
    tokens = rng.normal(size=(b, T, P * P * C)).astype(np.float32)
    pos = np.zeros((b, T, head_dim), np.float32)
    mask = np.arange(T)[None] < valid[:, None]
    for i, n in enumerate(valid):
        pos[i, :n] = rope_freqs_2d(head_dim, 8, 8)[:n]
    tokens[~mask] = 0
    return {"tokens": tokens, "pos": pos, "mask": mask,
            "label": rng.integers(0, NUM_CLASSES, size=b).astype(np.int32),
            "t": rng.integers(0, 1000, size=b).astype(np.int32)}


@pytest.mark.parametrize("backend", ["fused", "xla"])
def test_mlp_diffusion_loss_and_grads_match_jax(backend):
    """Loss and every gradient leaf of a FiT with tanh-GELU MLP blocks
    against jax.value_and_grad of fit_tpu's diffusion_loss (fit_tpu's
    interpreted flash attention or its XLA attention), t and noise
    injected."""
    batch = make_batch(2, seed=1)
    jm = JaxFiT(patch_size=P, in_channels=C, hidden_size=HID, depth=DEPTH, num_heads=HEADS, num_classes=NUM_CLASSES,
                class_dropout_prob=0.0, attn_backend=backend, scan_blocks=False, ffn="mlp")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jm.init({"params": jax.random.PRNGKey(0), "label_dropout": jax.random.PRNGKey(1)},
                     *(jbatch[k] for k in ("tokens", "t", "label", "pos", "mask")), train=True)
    leaves, td = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(5), len(leaves))
    params = jax.tree.unflatten(td, [0.05 * jax.random.normal(k, x.shape, x.dtype) for k, x in zip(keys, leaves)])
    rng = jax.random.PRNGKey(3)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_diffusion_loss(jm.apply, p, j_create_diffusion(None), jbatch, rng), has_aux=True)(params)

    model = FiT(patch_size=P, in_channels=C, hidden_size=HID, depth=DEPTH, num_heads=HEADS, num_classes=NUM_CLASSES,
                class_dropout_prob=0.0, ffn="mlp", device="cpu")
    assert all(isinstance(blk.ffn, GeluMlp) for blk in model.blocks)
    model.load_state_dict(torch_state_dict_from_flax(jax.tree.map(np.asarray, params), DEPTH))
    noise = np.asarray(jax.random.normal(jax.random.split(rng, 4)[1], batch["tokens"].shape, jnp.float32))
    tb = {k: torch.from_numpy(np.array(v)) for k, v in dict(batch, noise=noise).items()}
    loss, _ = diffusion_loss(model, create_diffusion(None), tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = torch_state_dict_from_flax(jax.tree.map(np.asarray, jgrads), DEPTH)
    for name, p in model.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-4 * max(np.abs(w).max(), 1e-30), rtol=0, err_msg=name)


def test_trainer_runs_mlp_blocks(tmp_path, monkeypatch):
    """The Trainer builds ffn="mlp" blocks, takes 2 steps and records the
    flavor in config.json, which the sample command line reads back."""
    import fit_tpu_torch.train.loop as loop

    def create(name, device="cuda", **kw):
        return FiT(patch_size=int(name.split("/")[1]), hidden_size=HID, depth=DEPTH, num_heads=HEADS, device=device,
                   **kw)

    monkeypatch.setattr(loop, "create_fit", create)
    rng = np.random.default_rng(0)
    for cls in ("a", "b"):
        (tmp_path / "latents" / cls).mkdir(parents=True)
        for i in range(4):
            np.save(tmp_path / "latents" / cls / f"{i}.npy", rng.normal(size=(4, 16, 16)).astype(np.float16))
    cfg = TrainConfig(feature_path=str(tmp_path / "latents"), feature_val_path="", results_dir=str(tmp_path / "r"),
                      model="FiT-S/2", image_size=64, num_classes=2, epochs=2, global_batch_size=4, grad_accum=2,
                      log_every=1, compute_dtype="float32", attn_backend="xla", num_workers=1, ffn="mlp")
    with ThreadPoolExecutor(1) as pool:
        trainer = Trainer(cfg, device="cpu")
        state = pool.submit(lambda: trainer.fit(max_steps=2)).result(timeout=WAIT_S)
    assert state.step == 2
    assert all(isinstance(blk.ffn, GeluMlp) for blk in trainer.model.blocks)
    with open(tmp_path / "r" / "FiT-S-2_metrics.jsonl") as f:
        losses = [json.loads(line)["train_loss"] for line in f if "train_loss" in line]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert json.loads((tmp_path / "r" / "config.json").read_text())["ffn"] == "mlp"
