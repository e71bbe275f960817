"""fit_tpu_torch's offline preprocessing against fit_tpu's, on the CPU.

``resize_dims`` is the same numpy arithmetic (equal over a grid of sizes);
``preprocess_folder(sample_posterior=False)`` on a tree of PNGs with the
same VAE weights (the small config, block_out_channels (8, 16, 16, 16), so
the latent is 1/8 of the image) writes the same files, latents within fp16
storage of fit_tpu's (1e-3 absolute: fp32 encodes within 1e-4, then each
side rounds to fp16) and a byte-identical ``path.json``; a rerun writes
nothing; the latents load through the port's ``LatentFolderDataset``; the
command line runs with ``--device cpu``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fit_tpu.data import preprocess as jpre
from fit_tpu.vae import AutoencoderKL as JaxVAE
from fit_tpu_torch.cli import preprocess as cli_preprocess
from fit_tpu_torch.data import preprocess as pre
from fit_tpu_torch.data.dataset import LatentFolderDataset, LatentLoader
from fit_tpu_torch.models.from_jax import torch_vae_state_dict_from_flax
from fit_tpu_torch.vae import AutoencoderKL

BLOCKS = (8, 16, 16, 16)
# (w, h) of the images: three rounded shapes, one image per shape twice
SIZES = [(100, 60), (64, 96), (300, 200), (100, 60), (50, 50)]


@pytest.mark.parametrize("scale", [8, 16, 32])
@pytest.mark.parametrize("max_size", [64, 256, 512])
def test_resize_dims_equal(max_size, scale):
    for w in (1, 5, 15, 16, 17, 63, 100, 255, 256, 257, 333, 640, 1000, 2048):
        for h in (1, 16, 31, 60, 96, 200, 256, 480, 1080):
            assert pre.resize_dims(w, h, max_size, scale) == jpre.resize_dims(w, h, max_size, scale), (w, h)


def write_tree(root):
    rng = np.random.default_rng(0)
    for i, (w, h) in enumerate(SIZES):
        cls = root / ("c1" if i % 2 else "c2")
        cls.mkdir(parents=True, exist_ok=True)
        ext = ".png" if i != 2 else ".jpg"
        Image.fromarray(rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)).save(cls / f"{i}{ext}")
    (root / "c1" / "notes.txt").write_text("not an image")


def test_walk_images(tmp_path):
    write_tree(tmp_path / "imgs")
    got = pre.walk_images(str(tmp_path / "imgs"))
    assert got == jpre.walk_images(str(tmp_path / "imgs")) and len(got) == len(SIZES)
    (tmp_path / "empty").mkdir()
    with pytest.raises(RuntimeError, match="Cannot find any image"):
        pre.walk_images(str(tmp_path / "empty"))


@pytest.fixture(scope="module")
def vaes():
    jvae = JaxVAE(block_out_channels=BLOCKS)
    params = jvae.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)), jax.random.PRNGKey(1))
    vae = AutoencoderKL(BLOCKS, device="cpu")
    vae.load_state_dict(torch_vae_state_dict_from_flax(jax.tree.map(np.asarray, params)))
    return jvae, params, vae


def test_preprocess_folder_matches_fit_tpu(tmp_path, vaes):
    jvae, params, vae = vaes
    data, out = tmp_path / "imgs", tmp_path / "latents"
    write_tree(data)
    kw = dict(max_size=64, batch_size=2, progress=False, sample_posterior=False)
    want_written = jpre.preprocess_folder(str(data), str(out), params, vae=jvae, **kw)
    want_manifest = (out / "path.json").read_bytes()
    want = {p: np.load(p) for p in want_written}
    for p in want:
        os.remove(p)
    os.remove(out / "path.json")

    got_written = pre.preprocess_folder(str(data), str(out), vae, **kw)
    assert sorted(got_written) == sorted(want_written) and len(got_written) == len(SIZES)
    assert (out / "path.json").read_bytes() == want_manifest
    for p, w in want.items():
        g = np.load(p)
        assert g.dtype == np.float16 and g.shape == w.shape
        np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32), atol=1e-3, rtol=0)
    # 100x60 under a 64^2 area rounds to 80x48 (w, h) -> (C, H/8, W/8)
    assert pre.resize_dims(100, 60, 64, 16) == (80, 48)
    assert np.load(out / "c2" / "0.npy").shape == (4, 48 // 8, 80 // 8)
    assert pre.preprocess_folder(str(data), str(out), vae, **kw) == []  # a rerun writes nothing
    assert (out / "path.json").read_bytes() == want_manifest


def test_posterior_draws_are_seeded(tmp_path, vaes):
    """sample_posterior=True draws its noise from the seed's generator: the
    same seed writes the same latents, another seed others, around the
    mean that sample_posterior=False writes."""
    _, _, vae = vaes
    data = tmp_path / "imgs"
    write_tree(data)
    runs = {}
    for name, kw in {"a": dict(seed=3), "b": dict(seed=3), "c": dict(seed=4), "mode": dict(sample_posterior=False)}.items():
        pre.preprocess_folder(str(data), str(tmp_path / name), vae, max_size=64, progress=False, **kw)
        runs[name] = np.load(tmp_path / name / "c1" / "1.npy").astype(np.float32)
    assert np.array_equal(runs["a"], runs["b"]) and not np.array_equal(runs["a"], runs["c"])
    assert 0 < np.abs(runs["a"] - runs["mode"]).max() < 10


def test_latents_load_through_the_port_loader(tmp_path, vaes):
    _, _, vae = vaes
    data, out = tmp_path / "imgs", tmp_path / "latents"
    write_tree(data)
    pre.preprocess_folder(str(data), str(out), vae, max_size=64, progress=False)
    ds = LatentFolderDataset(str(out), patch_size=2, sample_size=64, head_dim=16)
    assert len(ds) == len(SIZES) and ds.label_mapping == {"c1": 0, "c2": 1}
    loader = LatentLoader(ds, 4, mode="pad", seed=0)
    batch = next(iter(loader.epoch_batches(0)))
    assert batch["tokens"].shape == (4, ds.max_length, 2 * 2 * 4) and batch["mask"].any(axis=1).all()
    assert np.isfinite(batch["tokens"]).all()


def test_preprocess_cli_on_cpu(tmp_path, vaes):
    """--config plus flags, a diffusers-named checkpoint in a directory
    (resolved by --vae), fp32 on the CPU; the latents equal
    preprocess_folder's with the same weights and seed."""
    from test_torch_port_vae import fake_diffusers_sd

    from fit_tpu_torch.vae import convert_state_dict

    data = tmp_path / "imgs"
    write_tree(data)
    sd = fake_diffusers_sd(block_out=BLOCKS)
    (tmp_path / "vae").mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "vae" / "sd-vae-ft-mse.bin")
    (tmp_path / "config.json").write_text(json.dumps({"dataset_path": str(data), "latent_folder": "ignored",
                                                      "batch_size": 3}))
    written = cli_preprocess.main(["--config", str(tmp_path / "config.json"), "--latent-folder", str(tmp_path / "cli"),
                                   "--vae-checkpoint", str(tmp_path / "vae"), "--vae", "mse", "--sample-size", "64",
                                   "--device", "cpu"])
    assert len(written) == len(SIZES)
    vae = AutoencoderKL(BLOCKS, device="cpu")
    vae.load_state_dict(convert_state_dict(sd, block_out_channels=BLOCKS))
    pre.preprocess_folder(str(data), str(tmp_path / "direct"), vae, max_size=64, batch_size=3, progress=False)
    for p in written:
        rel = os.path.relpath(p, tmp_path / "cli")
        np.testing.assert_array_equal(np.load(p), np.load(tmp_path / "direct" / rel))


def test_preprocess_cli_needs_a_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("there is a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_preprocess.main(["--dataset-path", str(tmp_path), "--latent-folder", str(tmp_path / "o")])
