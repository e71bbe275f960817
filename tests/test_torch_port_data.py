"""fit_tpu_torch's data path, geometry, timestep samplers and training
diffusion math against fit_tpu's, on the CPU.

The loader is numpy on both sides, so its batches must be byte-identical to
``fit_tpu``'s (``fit_tpu`` may take its native C++ packer, which is held to
the same bytes), pad and bucket, from any ``start_batch``. The diffusion
terms are fp32 against fp32: 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fit_tpu.core import geometry as jgeo
from fit_tpu.data import dataset as jds
from fit_tpu.diffusion import gaussian as jgauss
from fit_tpu.diffusion import timestep_samplers as jts
from fit_tpu.diffusion import create_diffusion as jax_create_diffusion
from fit_tpu_torch.core import geometry
from fit_tpu_torch.data import dataset
from fit_tpu_torch.diffusion import gaussian, timestep_samplers
from fit_tpu_torch.diffusion.gaussian import create_diffusion

SHAPES = ((4, 16, 16), (4, 12, 20), (4, 20, 12), (4, 8, 8))


@pytest.fixture(scope="module")
def latent_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("latents")
    rng = np.random.default_rng(0)
    for cls in ("cat", "dog", "eel"):
        (root / cls).mkdir()
        for i in range(7):
            np.save(root / cls / f"{i}.npy", rng.normal(size=SHAPES[i % len(SHAPES)]).astype(np.float16))
    return str(root)


def assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("mode", ["pad", "bucket"])
@pytest.mark.parametrize("start_batch", [0, 2])
def test_loader_batches_are_byte_identical(latent_root, mode, start_batch):
    kw = dict(patch_size=2, sample_size=128, head_dim=16)
    ours = dataset.LatentLoader(dataset.LatentFolderDataset(latent_root, **kw), 4, mode=mode, seed=3, buckets=(16, 32, 64))
    theirs = jds.LatentLoader(jds.LatentFolderDataset(latent_root, **kw), 4, mode=mode, seed=3, buckets=(16, 32, 64))
    assert len(ours) == len(theirs) == 5
    for epoch in (0, 1):
        want = list(theirs.epoch_batches(epoch, start_batch=start_batch))
        got = list(ours.epoch_batches(epoch, start_batch=start_batch))
        assert len(got) == len(want) == 5 - start_batch
        for g, w in zip(got, want):
            assert_batches_equal(g, w)
        # the prefetching iterator builds the same batches in the same order
        for g, w in zip(ours.prefetched(epoch, num_threads=3, depth=2, start_batch=start_batch), want):
            assert_batches_equal(g, w)


def test_dataset_entries_labels_and_tables(latent_root):
    kw = dict(patch_size=2, sample_size=128, head_dim=16, hflip=False)
    ours, theirs = dataset.LatentFolderDataset(latent_root, **kw), jds.LatentFolderDataset(latent_root, **kw)
    assert ours.entries == theirs.entries and ours.label_mapping == theirs.label_mapping
    assert ours.max_length == theirs.max_length == 64
    for i in range(len(theirs)):
        a, b = ours[i], theirs[i]
        assert (a.label, a.h, a.w) == (b.label, b.h, b.w)
        assert a.tokens.tobytes() == b.tokens.tobytes() and a.pos.tobytes() == b.pos.tobytes()
    with pytest.raises(ValueError, match="packing mode"):
        dataset.LatentLoader(ours, 4, mode="ragged")


def test_patchify_np_and_pad_tokens_match():
    x = np.random.default_rng(1).normal(size=(4, 6, 10)).astype(np.float32)
    np.testing.assert_array_equal(geometry.patchify_np(x, 2), jgeo.patchify_np(x, 2))
    toks = geometry.patchify_np(x, 2)  # 15 tokens
    for n in (20, 15, 9):
        np.testing.assert_array_equal(geometry.pad_tokens(toks, n).numpy(), np.asarray(jgeo.pad_tokens(toks, n)))
    # the batched patchify and its numpy version agree
    np.testing.assert_array_equal(geometry.patchify(torch.from_numpy(x)[None], 2)[0].numpy(), toks)


@pytest.mark.parametrize("name", ["uniform", "loss-second-moment"])
def test_timestep_samplers_match(name):
    ours = timestep_samplers.create_named_schedule_sampler(name, 50)
    theirs = jts.create_named_schedule_sampler(name, 50)
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(60):  # warms the second-moment history up (10 losses for each of 50 t)
        (t1, w1), (t2, w2) = ours.sample(16, r1), theirs.sample(16, r2)
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_array_equal(w1, w2)
        losses = np.abs(np.sin(t1.astype(np.float64))) + 0.1
        ours.update_with_local_losses(t1, losses)
        theirs.update_with_local_losses(t2, losses)
    np.testing.assert_array_equal(ours.weights(), theirs.weights())
    with pytest.raises(NotImplementedError):
        timestep_samplers.create_named_schedule_sampler("nope", 10)


def test_training_diffusion_terms_match():
    rng = np.random.default_rng(5)
    x0 = rng.normal(size=(3, 10, 16)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    out = rng.normal(size=x0.shape).astype(np.float32)
    t = np.array([0, 517, 999], np.int32)
    mask = np.arange(10)[None] < np.array([10, 4, 1])[:, None]
    ours, theirs = create_diffusion(None), jax_create_diffusion(None)
    assert ours.original_num_steps == theirs.original_num_steps == 1000
    tt = torch.from_numpy(t)

    def close(a, b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)

    close(ours.q_sample(torch.from_numpy(x0), tt, torch.from_numpy(noise)), theirs.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise)))
    for a, b in zip(ours.q_mean_variance(torch.from_numpy(x0), tt), theirs.q_mean_variance(jnp.asarray(x0), jnp.asarray(t))):
        close(a, b)
    se = (out - noise) ** 2
    close(gaussian.masked_mean_flat(torch.from_numpy(se), torch.from_numpy(mask)), jgauss.masked_mean_flat(jnp.asarray(se), jnp.asarray(mask)))
    close(gaussian.masked_mean_flat(torch.from_numpy(se), None), jgauss.masked_mean_flat(jnp.asarray(se), None))
    close(
        gaussian.masked_global_mse(torch.from_numpy(out), torch.from_numpy(noise), torch.from_numpy(mask)),
        jgauss.masked_global_mse(jnp.asarray(out), jnp.asarray(noise), jnp.asarray(mask)),
    )
    model = lambda x, ts: x * 0.5  # noqa: E731 — any deterministic model
    got = ours.training_losses(model, torch.from_numpy(x0), tt, torch.from_numpy(noise), torch.from_numpy(mask))
    want = theirs.training_losses(model, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise), jnp.asarray(mask))
    close(got["loss"], want["loss"])
    close(got["mse"], want["mse"])
    # learn_sigma: the model's second half of axis 1 is the variance, learned through the vb term
    sigma_model = lambda x, ts: torch.cat([x * 0.5, torch.tanh(x)], dim=1)  # noqa: E731
    j_sigma_model = lambda x, ts: jnp.concatenate([x * 0.5, jnp.tanh(x)], axis=1)  # noqa: E731
    got = create_diffusion(None, learn_sigma=True).training_losses(
        sigma_model, torch.from_numpy(x0), tt, torch.from_numpy(noise), torch.from_numpy(mask))
    want = jax_create_diffusion(None, learn_sigma=True).training_losses(
        j_sigma_model, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise), jnp.asarray(mask))
    assert set(got) == set(want) == {"mse", "vb", "loss"}
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)
