"""fit_tpu_torch's training path against fit_tpu's, on the CPU.

The same inputs, made with numpy from seeds, and the same random weights
(carried by ``from_jax``) go through ``fit_tpu``'s loss, train step and
train state and through the port's. Contract size: hidden 96, 6 heads,
depth 2, T 64, fp32; attention runs the kernels' plain versions here (the
kernels are held against them on the card, tests/test_torch_port_cuda.py).

Tolerances:
- loss: 1e-5 relative; gradients: 1e-4 of each leaf's max |g| (fp32, sums
  in another order through a depth-2 model);
- one AdamW update: 1e-2 x lr per element. The Adam direction
  m / (sqrt(v) + eps) is ill-conditioned only where sqrt(v) ~ eps = 1e-8:
  there a gradient of ~1e-10, which two fp32 summation orders do not agree
  on (they differ by ~1e-10, and in sign), moves the element by a fraction
  of lr (measured: up to 1.9e-2 x lr, at |g| = 5e-10, on 3 of ~70k
  elements). So the bar holds wherever sqrt(v_hat) > 10 eps, and the few
  elements below it (0.4% here, many with no gradient at all; the test
  requires under 1%) are held to the direction's own range, 2 x lr a step;
- the EMA shadow: 1e-7 (decay 0.9999 damps the update's difference 1e4x).

Stochastic rounding draws other bits than fit_tpu's, so its tests are
distribution tests, ports of tests/test_sr_state.py. The Trainer runs end
to end on tiny synthetic latents; every run waits with a timeout.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fit_tpu.core.pos_embed import rope_freqs_2d
from fit_tpu.diffusion import create_diffusion as jax_create_diffusion
from fit_tpu.models import FiT as JaxFiT
from fit_tpu.models.layers import LabelEmbedder as JaxLabelEmbedder
from fit_tpu.train.state import create_train_state as jax_create_train_state
from fit_tpu.train.state import make_optimizer as jax_make_optimizer
from fit_tpu.train.step import diffusion_loss as jax_diffusion_loss
from fit_tpu.train.step import make_train_step as jax_make_train_step
from fit_tpu.train.step import split_for_accumulation as jax_split
from fit_tpu.utils.config import TrainConfig as JaxTrainConfig
from fit_tpu_torch.diffusion.gaussian import create_diffusion
from fit_tpu_torch.models.fit import FiT
from fit_tpu_torch.models.from_jax import torch_state_dict_from_flax, torch_train_state_from_flax
from fit_tpu_torch.models.layers import LabelEmbedder
from fit_tpu_torch.train.loop import Trainer, _check_supported
from fit_tpu_torch.train.state import (
    AdamSR,
    create_train_state,
    ema_update,
    make_optimizer,
    stochastic_round,
)
from fit_tpu_torch.train.step import diffusion_loss, make_train_step, split_for_accumulation
from fit_tpu_torch.utils.checkpoint import CheckpointManager
from fit_tpu_torch.utils.config import TrainConfig, add_dataclass_args, from_args

T, P, C = 64, 2, 4
HID, HEADS, DEPTH = 96, 6, 2
HEAD_DIM = HID // HEADS
NUM_CLASSES = 10
LR = 1e-3
WAIT_S = 300  # the longest a Trainer run in these tests may take


def jax_model(backend="xla", dropout=0.0, scan=False):
    return JaxFiT(
        patch_size=P, in_channels=C, hidden_size=HID, depth=DEPTH, num_heads=HEADS,
        num_classes=NUM_CLASSES, class_dropout_prob=dropout, attn_backend=backend, scan_blocks=scan,
    )


def torch_model(dropout=0.0, remat=False):
    return FiT(
        patch_size=P, in_channels=C, hidden_size=HID, depth=DEPTH, num_heads=HEADS,
        num_classes=NUM_CLASSES, class_dropout_prob=dropout, remat=remat,
    )


def make_batch(b, seed, valid=None):
    rng = np.random.default_rng(seed)
    valid = rng.integers(20, T + 1, size=b) if valid is None else np.asarray(valid)
    tokens = rng.normal(size=(b, T, P * P * C)).astype(np.float32)
    pos = np.zeros((b, T, HEAD_DIM), np.float32)
    mask = np.arange(T)[None] < valid[:, None]
    for i, n in enumerate(valid):
        pos[i, :n] = rope_freqs_2d(HEAD_DIM, 8, 8)[:n]
    tokens[~mask] = 0
    return {
        "tokens": tokens, "pos": pos, "mask": mask,
        "label": rng.integers(0, NUM_CLASSES, size=b).astype(np.int32),
        "t": rng.integers(0, 1000, size=b).astype(np.int32),
    }


def random_params(model, batch, seed):
    params = model.init(
        {"params": jax.random.PRNGKey(0), "label_dropout": jax.random.PRNGKey(1)},
        *(jnp.asarray(batch[k]) for k in ("tokens", "t", "label", "pos", "mask")), train=True,
    )
    leaves, td = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree.unflatten(td, [0.05 * jax.random.normal(k, l.shape, l.dtype) for k, l in zip(keys, leaves)])


def port(params, **kw):
    model = torch_model(**kw)
    model.load_state_dict(torch_state_dict_from_flax(jax.tree.map(np.asarray, params), DEPTH))
    return model


def jax_noise(rng, shape):
    """The noise fit_tpu's diffusion_loss draws from ``rng``."""
    return np.asarray(jax.random.normal(jax.random.split(rng, 4)[1], shape, jnp.float32))


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def assert_grads_close(model, jax_grads):
    want = torch_state_dict_from_flax(jax.tree.map(np.asarray, jax_grads), DEPTH)
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        tol = 1e-4 * max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name)


def assert_update_close(model, jstate, steps):
    """Params after ``steps`` AdamW steps against fit_tpu's (see the module
    docstring for the conditioning of the Adam direction)."""
    adam = jstate.opt_state[0]
    nu = torch_state_dict_from_flax(jax.tree.map(np.asarray, adam.nu), DEPTH)
    want = torch_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params), DEPTH)
    c2 = 1.0 - 0.999 ** int(adam.count)
    below = total = 0
    for name, p in model.named_parameters():
        diff = (p.detach() - want[name]).abs()
        conditioned = (nu[name] / c2).sqrt() > 10 * 1e-8
        assert diff[conditioned].max().item() <= 1e-2 * LR, name
        assert diff.max().item() <= 2 * LR * steps, name
        below, total = below + int((~conditioned).sum()), total + diff.numel()
    assert below < 1e-2 * total


def assert_params_close(model, jax_params, atol, what="params"):
    want = torch_state_dict_from_flax(jax.tree.map(np.asarray, jax_params), DEPTH)
    got = dict(model.named_parameters()) if isinstance(model, torch.nn.Module) else model
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().float().numpy(), w.numpy(), atol=atol, rtol=0, err_msg=f"{what} {name}")


# --- the loss, its gradients, and the update ---------------------------------


@pytest.mark.parametrize("backend", ["fused", "xla"])
def test_diffusion_loss_and_grads_match_jax(backend):
    """Loss and every gradient leaf against jax.value_and_grad of
    fit_tpu.train.step.diffusion_loss, with t and the noise injected."""
    batch = make_batch(2, seed=1)
    jm = jax_model(backend)
    params = random_params(jm, batch, seed=5)
    rng = jax.random.PRNGKey(3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_diffusion_loss(jm.apply, p, jax_create_diffusion(None), jbatch, rng), has_aux=True
    )(params)

    model = port(params)
    tb = to_torch(dict(batch, noise=jax_noise(rng, batch["tokens"].shape)))
    loss, (t, per_sample) = diffusion_loss(model, create_diffusion(None), tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert torch.equal(t, tb["t"]) and per_sample.shape == (2,)
    assert_grads_close(model, jgrads)


def test_train_step_grad_accum_matches_jax():
    """One grad_accum=2 step (micro-grads averaged, then one AdamW and one
    EMA update) against fit_tpu's make_train_step."""
    batch = make_batch(4, seed=2)
    jm = jax_model()
    params = random_params(jm, batch, seed=6)
    tx = jax_make_optimizer(LR)
    jstep = jax_make_train_step(jm.apply, jax_create_diffusion(None), tx, grad_accum=2, donate=False)
    rng = jax.random.PRNGKey(11)
    split = jax_split({k: jnp.asarray(v) for k, v in batch.items()}, 2)
    jstate, jmetrics = jstep(jax_create_train_state(params, tx), split, rng)

    model = port(params)
    state = create_train_state(model, make_optimizer(model.parameters(), LR))
    noise = np.stack([jax_noise(k, (2, T, P * P * C)) for k in jax.random.split(rng, 2)])
    tb = split_for_accumulation(to_torch(batch), 2)
    tb["noise"] = torch.from_numpy(noise)
    state, metrics = make_train_step(create_diffusion(None), grad_accum=2)(state, tb, None)
    assert state.step == int(jstate.step) == 1
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jmetrics["grad_norm"]), rtol=1e-4)
    assert_update_close(model, jstate, steps=1)
    assert_params_close(state.ema, jstate.ema_params, atol=1e-7, what="ema")


def _jax_step_inputs(seed):
    batch = make_batch(2, seed=seed)
    rng = jax.random.PRNGKey(seed)
    return batch, rng, dict(batch, noise=jax_noise(rng, batch["tokens"].shape))


def test_two_steps_from_a_carried_jax_train_state():
    """A fit_tpu TrainState one step in (nonzero moments, count 1) carried by
    torch_train_state_from_flax; then two more steps on each side agree."""
    jm = jax_model()
    batch0, rng0, _ = _jax_step_inputs(20)
    params = random_params(jm, batch0, seed=7)
    tx = jax_make_optimizer(LR)
    jstep = jax_make_train_step(jm.apply, jax_create_diffusion(None), tx, donate=False)
    jstate, _ = jstep(jax_create_train_state(params, tx), {k: jnp.asarray(v) for k, v in batch0.items()}, rng0)

    model = torch_model()
    state = torch_train_state_from_flax(jax.tree.map(np.asarray, jstate), model, make_optimizer(model.parameters(), LR))
    assert state.step == 1
    assert_params_close(model, jstate.params, atol=0)
    assert_params_close(state.ema, jstate.ema_params, atol=0, what="ema")
    step = make_train_step(create_diffusion(None))
    for seed in (21, 22):
        batch, rng, tbatch = _jax_step_inputs(seed)
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        state, _ = step(state, to_torch(tbatch), None)
    assert state.step == int(jstate.step) == 3
    assert_update_close(model, jstate, steps=2)
    assert_params_close(state.ema, jstate.ema_params, atol=1e-7, what="ema")


@pytest.mark.parametrize("scan,dtype", [(False, torch.bfloat16), (True, torch.float32)], ids=["unrolled-bf16-sr", "scan-fp32"])
def test_carried_sr_state_keeps_bf16_moments(scan, dtype):
    """A fit_tpu state carries exactly, from an unrolled tree with bf16
    stochastic-rounding moments and EMA into AdamSR (bf16 values, same
    count) and from a scan-stacked tree into AdamW; a step then runs."""
    jm = jax_model(scan=scan)
    batch, _, _ = _jax_step_inputs(30)
    params = random_params(jm, batch, seed=8)
    sr = dtype == torch.bfloat16
    tx = jax_make_optimizer(LR, moment_dtype=jnp.bfloat16 if sr else None)
    jstate = jax_create_train_state(params, tx, ema_dtype=jnp.bfloat16 if sr else jnp.float32)
    grads = random_params(jm, batch, seed=9)  # any tree of the params' shapes
    _, opt_state = tx.update(grads, jstate.opt_state, jstate.params)
    jstate = jstate.replace(step=jnp.asarray(1, jnp.int32), opt_state=opt_state)
    assert ("blocks" in params["params"]) == scan
    model = torch_model()
    gen = torch.Generator().manual_seed(0)
    opt = make_optimizer(model.parameters(), LR, moment_dtype=dtype, generator=gen)
    state = torch_train_state_from_flax(jax.tree.map(np.asarray, jstate), model, opt, ema_dtype=dtype)
    assert_params_close(model, jstate.params, atol=0)
    mu = torch_state_dict_from_flax(jax.tree.map(np.asarray, jstate.opt_state[0].mu), DEPTH)
    nu = torch_state_dict_from_flax(jax.tree.map(np.asarray, jstate.opt_state[0].nu), DEPTH)
    for name, p in model.named_parameters():
        st = opt.state[p]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == state.ema[name].dtype == dtype
        assert torch.equal(st["exp_avg"].float(), mu[name]) and torch.equal(st["exp_avg_sq"].float(), nu[name])
        assert st["step"].item() == 1
    state, metrics = make_train_step(create_diffusion(None), sr_generator=gen)(state, to_torch(_jax_step_inputs(31)[2]), None)
    assert state.step == 2 and np.isfinite(metrics["loss"].item())


def test_remat_gives_the_same_gradients():
    """FiT(remat=True) recomputes each block in the backward
    (torch.utils.checkpoint): the same loss and gradients."""
    batch = to_torch(dict(make_batch(2, seed=4), noise=np.random.default_rng(0).normal(size=(2, T, 16)).astype(np.float32)))
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = torch_model(remat=remat)
        with torch.no_grad():
            for p in model.parameters():
                p.normal_(0, 0.05, generator=torch.Generator().manual_seed(p.numel()))
        loss, _ = diffusion_loss(model, create_diffusion(None), batch)
        loss.backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# --- label dropout draws from an explicit generator --------------------------


def test_label_dropout_uses_the_passed_generator():
    emb = LabelEmbedder(NUM_CLASSES, 8, 0.1)
    labels = torch.randint(0, NUM_CLASSES, (10_000,), generator=torch.Generator().manual_seed(0))
    null = emb.table.weight[NUM_CLASSES]

    def dropped(seed):
        out = emb(labels, True, torch.float32, generator=torch.Generator().manual_seed(seed))
        return (out == null).all(dim=-1)

    a, b, c = dropped(1), dropped(1), dropped(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    n, p = labels.numel(), 0.1
    assert abs(a.sum().item() - n * p) <= 3 * (n * p * (1 - p)) ** 0.5
    with pytest.raises(ValueError, match="generator"):
        emb(labels, True, torch.float32)
    assert torch.equal(emb(labels[:4], False, torch.float32), emb.table(labels[:4]))  # eval: no draw


def test_force_drop_ids_match_flax():
    labels = np.array([3, 7, 1, 9], np.int32)
    drop = np.array([1, 0, 1, 0], np.int32)
    jemb = JaxLabelEmbedder(NUM_CLASSES, 8, 0.1)
    variables = jemb.init(jax.random.PRNGKey(0), jnp.asarray(labels), train=False)
    want = np.asarray(jemb.apply(variables, jnp.asarray(labels), train=True, force_drop_ids=jnp.asarray(drop)))
    emb = LabelEmbedder(NUM_CLASSES, 8, 0.1)
    with torch.no_grad():
        emb.table.weight.copy_(torch.from_numpy(np.asarray(variables["params"]["table"]["embedding"])))
    got = emb(torch.from_numpy(labels), True, torch.float32, force_drop_ids=torch.from_numpy(drop))
    np.testing.assert_array_equal(got.detach().numpy(), want)


# --- stochastic rounding and the bf16 state (ports of tests/test_sr_state.py) --


def _bf16_neighbors(x32: np.ndarray):
    bits = x32.view(np.uint32)
    lo = (bits & 0xFFFF0000).view(np.float32)
    hi = ((bits & 0xFFFF0000) + np.where(bits & 0xFFFF, 0x10000, 0)).view(np.uint32).view(np.float32)
    return lo, hi


def test_stochastic_round_two_neighbors_and_unbiased():
    x = np.float32(1.0 + 1e-3)
    lo, hi = _bf16_neighbors(np.array([x]))
    gen = torch.Generator().manual_seed(0)
    vals = stochastic_round(torch.full((8192,), float(x)), gen).float()
    assert set(vals.unique().tolist()) <= {float(lo[0]), float(hi[0])}
    ulp = float(hi[0] - lo[0])
    assert abs(vals.mean().item() - float(x)) < 0.05 * ulp


def test_stochastic_round_exact_values_and_negatives():
    x = torch.linspace(-4, 4, 33).bfloat16().float()
    for seed in range(3):
        assert torch.equal(stochastic_round(x, torch.Generator().manual_seed(seed)).float(), x)
    neg = np.float32(-3.0 - 7e-3)
    mean = stochastic_round(torch.full((8192,), float(neg)), torch.Generator().manual_seed(2)).float().mean().item()
    assert abs(mean - float(neg)) < 2e-3 * abs(neg)
    with pytest.raises(TypeError):
        stochastic_round(x.double(), torch.Generator())


def test_adam_sr_tracks_fp32_adamw():
    lr = 1e-2
    p32 = [torch.ones(64, requires_grad=True), torch.full((8,), -0.5, requires_grad=True)]
    p16 = [p.detach().clone().requires_grad_(True) for p in p32]
    o32 = make_optimizer(p32, lr)
    o16 = make_optimizer(p16, lr, moment_dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    assert isinstance(o16, AdamSR)
    rng = np.random.default_rng(0)
    for _ in range(20):
        for a, b in zip(p32, p16):
            g = torch.from_numpy(rng.normal(size=a.shape).astype(np.float32))
            a.grad, b.grad = g.clone(), g.clone()
        o32.step()
        o16.step()
    assert all(o16.state[p]["exp_avg"].dtype == torch.bfloat16 for p in p16)
    for a, b, start in zip(p32, p16, (1.0, -0.5)):
        moved = (a - start).abs().max().item() + 1e-6
        assert (a - b).abs().max().item() < 0.05 * max(moved, lr)


def test_adam_sr_weight_decay_matches_adamw():
    lr, wd = 1e-2, 0.1
    a, b = torch.full((16,), 2.0, requires_grad=True), torch.full((16,), 2.0, requires_grad=True)
    o32 = make_optimizer([a], lr, wd)
    o16 = make_optimizer([b], lr, wd, moment_dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    a.grad, b.grad = torch.zeros(16), torch.zeros(16)
    o32.step()
    o16.step()
    torch.testing.assert_close(b.detach(), a.detach(), rtol=1e-6, atol=1e-8)  # pure decay: p (1 - lr wd)


def test_ema_bf16_sr_moves_where_nearest_rounding_stalls():
    decay, n = 0.9999, 4096
    target = {"w": torch.full((n,), 1.01)}
    e32 = {"w": torch.ones(n)}
    e16 = {"w": torch.ones(n).bfloat16()}
    nearest = torch.ones(n).bfloat16()
    gen = torch.Generator().manual_seed(3)
    for _ in range(400):
        ema_update(e32, target, decay)
        ema_update(e16, target, decay, generator=gen)
        nearest = (decay * nearest.float() + (1 - decay) * target["w"]).bfloat16()
    moved32 = e32["w"].mean().item() - 1.0
    moved16 = e16["w"].float().mean().item() - 1.0
    assert moved32 > 3e-4
    assert abs(nearest.float().mean().item() - 1.0) < 1e-5
    assert abs(moved16 - moved32) < 0.1 * moved32
    with pytest.raises(ValueError, match="stochastic rounding"):
        ema_update({"w": torch.ones(4).bfloat16()}, {"w": torch.zeros(4)}, decay)


# --- checkpoint, config, entry points ----------------------------------------


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16-sr"])
def test_checkpoint_roundtrip(tmp_path, state_dtype):
    model = torch_model()
    gen = torch.Generator().manual_seed(0)
    opt = make_optimizer(model.parameters(), LR, moment_dtype=state_dtype, generator=gen)
    state = create_train_state(model, opt, ema_dtype=state_dtype)
    batch = to_torch(make_batch(2, seed=9))
    state, _ = make_train_step(create_diffusion(None), sr_generator=gen)(state, batch, torch.Generator().manual_seed(1))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state.step, state, host_state={"epoch": 2})
    assert mgr.latest_step() == 1 and (tmp_path / "ckpt" / "host_1.json").exists()

    model2 = torch_model()
    opt2 = make_optimizer(model2.parameters(), LR, moment_dtype=state_dtype, generator=torch.Generator())
    restored, host = mgr.restore(state=create_train_state(model2, opt2, ema_dtype=state_dtype))
    assert host == {"epoch": 2} and restored.step == 1
    for (n, a), b in zip(model.named_parameters(), model2.parameters()):
        assert torch.equal(a, b) and torch.equal(state.ema[n], restored.ema[n])
        s1, s2 = opt.state[a], opt2.state[b]
        assert s2["exp_avg"].dtype == s1["exp_avg"].dtype and torch.equal(s1["exp_avg_sq"], s2["exp_avg_sq"])
    assert CheckpointManager(str(tmp_path / "empty")).restore() == (None, None)


def test_train_config_matches_fit_tpu():
    """The same fields, defaults and flags as fit_tpu's TrainConfig."""
    import argparse
    import dataclasses

    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    assert ours == theirs
    parser = argparse.ArgumentParser()
    add_dataclass_args(parser, TrainConfig)
    cfg = from_args(TrainConfig, parser.parse_args(["--model", "FiT-S/2", "--global-batch-size", "8",
                                                   "--token-buckets", "32", "64", "--use-wandb", "false"]))
    assert (cfg.model, cfg.global_batch_size, cfg.token_buckets, cfg.use_wandb) == ("FiT-S/2", 8, (32, 64), False)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("there is a card: the default device is usable")


def test_default_sampler_without_a_card_raises():
    """A sampler built without device= means the card; without one it raises
    rather than sampling on the CPU."""
    from fit_tpu_torch.sampling import FiTSampler

    _no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FiTSampler(torch_model())


@pytest.mark.parametrize("entry", ["server", "trainer", "create_fit"])
def test_default_entry_points_without_a_card_raise(tmp_path, entry):
    from fit_tpu_torch.models.fit import create_fit
    from fit_tpu_torch.serve import SamplingServer

    _no_card()
    build = {
        "server": lambda: SamplingServer(torch_model()),
        "trainer": lambda: Trainer(TrainConfig(feature_path=str(tmp_path), results_dir=str(tmp_path / "r"))),
        "create_fit": lambda: create_fit("FiT-S/2"),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()


@pytest.mark.parametrize(
    "change,device,match",
    [
        (dict(tp=2), "cpu", "tp=2"),
        (dict(sp=2), "cpu", "sp=2"),
        (dict(pp=2), "cpu", "pp=2"),
        (dict(ep=2), "cpu", "ep=2"),
        (dict(fsdp=True), "cpu", "fsdp"),
        (dict(ffn="moe"), "cpu", "ffn"),
        (dict(attn_backend="xla"), "cuda", "attn_backend"),
        (dict(packing="ragged"), "cpu", "packing"),
    ],
    ids=["tp", "sp", "pp", "ep", "fsdp", "ffn", "xla-on-card", "packing"],
)
def test_trainer_refuses_what_it_does_not_run(change, device, match):
    with pytest.raises((NotImplementedError, ValueError), match=match):
        _check_supported(TrainConfig(**change), torch.device(device))
    _check_supported(TrainConfig(attn_backend="xla"), torch.device("cpu"))  # the CPU runs the plain versions


# --- the Trainer end to end ---------------------------------------------------


@pytest.fixture
def tiny_models(monkeypatch):
    """The Trainer builds its model by registry name; here every name builds
    the contract-size FiT (hidden 96, 6 heads, depth 2), so a step takes
    milliseconds and a checkpoint a few MB."""
    import fit_tpu_torch.train.loop as loop

    def create(name, device="cuda", **kw):
        patch = int(name.split("/")[1])
        return FiT(patch_size=patch, hidden_size=HID, depth=DEPTH, num_heads=HEADS, device=device, **kw)

    monkeypatch.setattr(loop, "create_fit", create)


def write_latents(root, n_per_class=8, shapes=((4, 16, 16),), seed=5):
    rng = np.random.default_rng(seed)
    for cls in ("a", "b"):
        (root / cls).mkdir(parents=True)
        for i in range(n_per_class):
            shape = shapes[i % len(shapes)]
            np.save(root / cls / f"{i}.npy", rng.normal(size=shape).astype(np.float16))


def trainer_cfg(root, results, **kw):
    base = dict(
        feature_path=str(root), feature_val_path="", results_dir=str(results), model="FiT-S/2",
        image_size=64, num_classes=2, epochs=4, global_batch_size=4, grad_accum=1, log_every=1,
        compute_dtype="float32", attn_backend="xla", num_workers=2,
    )
    base.update(kw)
    return TrainConfig(**base)


def fit(cfg, max_steps):
    """Trainer(cfg).fit(max_steps) on the CPU, waited for with a timeout."""
    with ThreadPoolExecutor(1) as pool:
        return pool.submit(lambda: Trainer(cfg, device="cpu").fit(max_steps=max_steps)).result(timeout=WAIT_S)


def logged(results, key="train_loss"):
    with open(results / "FiT-S-2_metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r[key] for r in recs if key in r}


@pytest.mark.parametrize(
    "packing,state_dtype,grad_accum", [("pad", "float32", 2), ("bucket", "bfloat16", 1)], ids=["pad-fp32", "bucket-bf16"]
)
def test_resume_reproduces_the_loss_stream(tmp_path, tiny_models, packing, state_dtype, grad_accum):
    """fit(4) == fit(1) -> checkpoint mid-epoch -> a fresh Trainer resumes
    -> fit(4): data order, noise, label dropout and (bf16 state) the
    stochastic rounding all continue exactly, across the epoch boundary at
    step 2 (8 latents, batch 4)."""
    root = tmp_path / "latents"
    write_latents(root, n_per_class=4, shapes=((4, 16, 16), (4, 12, 20)))
    kw = dict(packing=packing, optimizer_state_dtype=state_dtype, grad_accum=grad_accum,
              token_buckets=(4, 8, 12, 16))
    fit(trainer_cfg(root, tmp_path / "straight", **kw), 4)
    want = logged(tmp_path / "straight")
    fit(trainer_cfg(root, tmp_path / "split", **kw), 1)
    state = fit(trainer_cfg(root, tmp_path / "split", **kw), 4)
    assert state.step == 4
    assert set(want) == set(range(1, 5)) and logged(tmp_path / "split") == want
    host = json.loads((tmp_path / "split" / "checkpoints" / "host_1.json").read_text())
    assert (host["epoch"], host["batch_index"], host["state_dtype"]) == (0, 1, state_dtype)


def test_trainer_validation_bucket_packing_and_cli(tmp_path, tiny_models):
    """Validation on the EMA logs val_loss each epoch; bucket batches take a
    budget from the bucket set; the loss-second-moment sampler's draws and
    weights reach the step; the command line trains too."""
    from fit_tpu_torch.cli.train import main

    root, val = tmp_path / "latents", tmp_path / "val"
    write_latents(root, n_per_class=4, shapes=((4, 16, 16), (4, 12, 20)))
    write_latents(val, n_per_class=2, seed=6)
    cfg = trainer_cfg(root, tmp_path / "run", feature_val_path=str(val), epochs=2, packing="bucket",
                      token_buckets=(4, 12), timestep_sampler="loss-second-moment")
    trainer = Trainer(cfg, device="cpu")
    seen = []
    real_step = trainer.train_step

    def step(state, batch, gen):
        assert batch["t"].dtype == torch.int32 and batch["t_weight"].shape == (4,)
        seen.append(batch["tokens"].shape[1])
        return real_step(state, batch, gen)

    trainer.train_step = step
    with ThreadPoolExecutor(1) as pool:
        state = pool.submit(trainer.fit).result(timeout=WAIT_S)
    assert state.step == 4 and set(seen) <= {4, 12}
    assert trainer.t_sampler._loss_counts.sum() == 4 * 4  # every sample's loss entered the history
    val_losses = logged(tmp_path / "run", "val_loss")
    assert sorted(val_losses) == [2, 4] and all(np.isfinite(v) for v in val_losses.values())
    assert CheckpointManager(str(tmp_path / "run" / "checkpoints")).steps() == [2, 4]

    with ThreadPoolExecutor(1) as pool:
        state = pool.submit(main, [
            "--device", "cpu", "--feature-path", str(root), "--feature-val-path", "", "--results-dir",
            str(tmp_path / "cli"), "--model", "FiT-S/2", "--image-size", "64", "--num-classes", "2",
            "--global-batch-size", "4", "--grad-accum", "1", "--compute-dtype", "float32", "--max-steps", "2",
            "--log-every", "1", "--num-workers", "1",
        ]).result(timeout=WAIT_S)
    assert state.step == 2 and len(logged(tmp_path / "cli")) == 2


@pytest.mark.parametrize(
    "sources,group",
    [
        (("rope_attention.cu", "rope_attention_sm90.cuh", "rope_attention_tf32.cuh"), "K1 attention forward"),
        (("rope_attention_bwd.cu", "rope_attention_bwd_mma.cuh", "rope_attention_bwd_tf32.cuh"),
         "K2 attention backward"),
    ],
    ids=["K1", "K2"],
)
def test_profile_train_groups_every_attention_kernel(sources, group):
    """Every __global__ kernel of the attention sources falls in its own
    group of profile_train (none in the elementwise rest), and K2's
    kernels each name one of its passes, so K2's group is their sum."""
    import re
    from pathlib import Path

    from fit_tpu_torch.cli import profile_train

    csrc = Path(profile_train.__file__).resolve().parents[1] / "ops" / "csrc"
    names = [
        name
        for src in sources
        for name in re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(", (csrc / src).read_text())
    ]
    assert names
    for name in names:
        device_name = f"void (anonymous namespace)::{name}<64>(int, float)"
        assert profile_train.group_of(device_name) == group, name
        if group.startswith("K2"):
            assert profile_train.k2_pass(device_name) in name
