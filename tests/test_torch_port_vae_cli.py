"""Pixels out of the port on the CPU: ``SamplingServer(vae=...)``, and
``cli.sample``, ``cli.demo`` and ``cli.serve`` with ``--vae-checkpoint``
and ``--device cpu``.

The VAE is a random diffusers state dict in the SD layout at small widths
(block_out_channels (8, 16, 16, 16), so an image is 8x its latent),
written as ``sd-vae-ft-ema.bin``. A served image is its latent decoded:
bit-identical to the port's direct decode of the latents a server without
the VAE returns for the same seeded requests, each decoded alone as the
server decodes it, and to itself served alone, also beside other requests
of its shape. The CLI's PNGs read back (PIL) equal
the images it returns, which are within one uint8 step of a direct decode
of the latents the same seed writes without the flag (bf16, the CLI's
default dtype, in another batch: one step covers a rounding that tips).
"""

import io
import json
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_port_cli import WAIT_S, sample, trained  # noqa: F401 — the module's fixture
from test_torch_port_vae import fake_diffusers_sd

from fit_tpu_torch.cli import demo, serve
from fit_tpu_torch.cli.serve import make_handler
from fit_tpu_torch.models.fit import FiT
from fit_tpu_torch.serve import SamplingServer
from fit_tpu_torch.vae import AutoencoderKL, convert_state_dict, load_autoencoder, to_uint8

BLOCKS = (8, 16, 16, 16)


@pytest.fixture(scope="module")
def vae_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("vae")
    sd = fake_diffusers_sd(block_out=BLOCKS, seed=11)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, root / "sd-vae-ft-ema.bin")
    return root


def small_vae(vae_dir, dtype=torch.float32):
    return load_autoencoder(str(vae_dir), "ema", dtype=dtype, device="cpu")


def contract_fit():
    model = FiT(patch_size=2, hidden_size=96, depth=2, num_heads=6, num_classes=10, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(2))
    return model


REQUESTS = [(1, 64, 64, 4), (2, 48, 80, 5), (3, 64, 64, 6)]


def served(model, vae=None, requests=REQUESTS):
    with SamplingServer(model, batch_size=4, max_batch_wait_s=0.5, num_sampling_steps=3, num_classes=10,
                        max_size=8, max_length=16, device="cpu", vae=vae) as srv:
        futs = [srv.submit(label, h, w, seed=seed) for label, h, w, seed in requests]
        return [f.result(timeout=WAIT_S) for f in futs], srv.stats()


def test_vae_server_images_are_its_latents_decoded(vae_dir):
    model, vae = contract_fit(), small_vae(vae_dir)
    images, stats = served(model, vae)
    latents, _ = served(model)
    assert stats["served"] == 3
    assert [im.shape for im in images] == [(h, w, 3) for _, h, w, _ in REQUESTS]
    assert all(im.dtype == np.uint8 for im in images)
    with torch.inference_mode():
        # the server's decodes: one request a call
        for i, latent in enumerate(latents):
            np.testing.assert_array_equal(images[i], to_uint8(vae.decode(torch.from_numpy(latent[None])))[0])
    alone, _ = served(model, vae, REQUESTS[1:2])  # the same seeded request without the others
    np.testing.assert_array_equal(alone[0], images[1])


def test_a_shape_spanning_several_decodes_gives_each_request_its_own_pixels(vae_dir):
    """Three 64x64 requests beside a 48x80 one, each decoded in its own
    call: each image is the same bits as its request served alone."""
    model, vae = contract_fit(), small_vae(vae_dir)
    requests = [(1, 64, 64, 4), (2, 48, 80, 5), (3, 64, 64, 6), (4, 64, 64, 7)]
    images, stats = served(model, vae, requests)
    assert stats["served"] == 4 and stats["batches"] == 1
    for i in (0, 2, 3):
        alone, _ = served(model, vae, requests[i:i + 1])
        np.testing.assert_array_equal(alone[0], images[i])


def test_vae_server_http_returns_png(vae_dir):
    from http.server import ThreadingHTTPServer

    with SamplingServer(contract_fit(), batch_size=2, max_batch_wait_s=0.05, num_sampling_steps=2, num_classes=10,
                        max_size=8, max_length=16, device="cpu", vae=small_vae(vae_dir)) as srv:
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            body = json.dumps({"label": 2, "height": 48, "width": 80, "seed": 7}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/sample", data=body)
            with urllib.request.urlopen(req, timeout=WAIT_S) as r:
                assert r.status == 200 and r.headers["Content-Type"] == "image/png"
                png = Image.open(io.BytesIO(r.read()))
                png.load()
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=60)
        direct = srv.submit(2, 48, 80, seed=7).result(timeout=WAIT_S)
    assert png.size == (80, 48) and png.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(png), direct)


@pytest.mark.parametrize("extra", [[], ["--image-sizes", "64x64,48x80"]], ids=["batched", "mixed"])
def test_sample_cli_writes_pngs_of_its_latents(trained, vae_dir, tmp_path, extra):  # noqa: F811
    _, ckpt = trained
    res = sample(ckpt, tmp_path / "png", "--sampler", "dpm", "--vae-checkpoint", str(vae_dir), *extra)
    plain = sample(ckpt, tmp_path / "npy", "--sampler", "dpm", *extra)
    assert res["labels"] == plain["labels"] and len(res["decode_seconds"]) == 2
    files = sorted((tmp_path / "png").iterdir(), key=lambda f: int(f.name.split("_")[2]))
    assert [f.name for f in files] == [f"generated_image_{i}_{lab}.png" for i, lab in enumerate(res["labels"])]
    vae = small_vae(vae_dir, torch.bfloat16)
    for i, (f, image, lat) in enumerate(zip(files, res["images"], plain["latents"])):
        np.testing.assert_array_equal(res["latents"][i], lat)  # the same seed, the same latents
        np.testing.assert_array_equal(np.asarray(Image.open(f)), image)
        with torch.inference_mode():
            direct = to_uint8(vae.decode(torch.from_numpy(lat)[None]))[0]
        assert image.shape == (8 * lat.shape[1], 8 * lat.shape[2], 3)
        assert np.abs(image.astype(int) - direct.astype(int)).max() <= 1


def test_demo_cli_writes_a_grid(trained, vae_dir, tmp_path):  # noqa: F811
    _, ckpt = trained
    out = tmp_path / "sample.png"
    with ThreadPoolExecutor(1) as pool:
        lat = pool.submit(demo.main, ["--checkpoint_path", ckpt, "--model", "FiT-S/2", "--num_sampling_steps", "2",
                                      "--image_size", "64", "--out", str(out), "--vae-checkpoint", str(vae_dir),
                                      "--device", "cpu"]).result(timeout=WAIT_S)
    grid = np.asarray(Image.open(out))
    assert grid.shape == (2 * 64, 4 * 64, 3) and lat.shape == (8, 4, 8, 8)
    vae = small_vae(vae_dir, torch.bfloat16)
    with torch.inference_mode():
        images = to_uint8(vae.decode(torch.from_numpy(lat)))
    np.testing.assert_array_equal(grid[64:, 128:192], images[6])  # row 2, column 3
    assert not (tmp_path / "sample_latents.npy").exists()


def test_serve_cli_with_a_vae_answers_png(trained, vae_dir):  # noqa: F811
    _, ckpt = trained
    httpd, server = serve.build(["--device", "cpu", "--checkpoint-path", ckpt, "--port", "0", "--sampler", "ddim",
                                 "--num-sampling-steps", "2", "--serve-batch-size", "2", "--no-warmup",
                                 "--vae-checkpoint", str(vae_dir), "--dtype", "float32"])
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        body = json.dumps({"label": 7, "height": 64, "width": 48, "seed": 3}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/sample", data=body)
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "image/png"
            png = np.asarray(Image.open(io.BytesIO(r.read())))
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        thread.join(timeout=60)
    assert png.shape == (64, 48, 3) and png.dtype == np.uint8
    assert isinstance(server.vae, AutoencoderKL) and server.vae.dtype == torch.float32
    assert server.vae.block_out_channels == BLOCKS


def test_vae_checkpoint_directory_resolves_by_kind(vae_dir):
    """--vae mse looks for sd-vae-ft-mse, which this directory lacks."""
    with pytest.raises(FileNotFoundError, match="sd-vae-ft-mse"):
        load_autoencoder(str(vae_dir), "mse", device="cpu")
    sd = torch.load(vae_dir / "sd-vae-ft-ema.bin", weights_only=True)
    ref = AutoencoderKL(BLOCKS, device="cpu")
    ref.load_state_dict(convert_state_dict(sd, BLOCKS))
    got = small_vae(vae_dir).state_dict()
    assert all(torch.equal(v, got[k]) for k, v in ref.state_dict().items())
