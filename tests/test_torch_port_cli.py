"""The port's command lines end to end on the CPU: the Trainer takes 2
steps on synthetic latents, then ``cli.sample`` (ddim, dpm, mixed sizes,
fp32, int8 with SmoothQuant), ``cli.quantize``, ``cli.demo``, a reference
checkpoint through ``--torch-checkpoint`` and ``cli.serve``'s construction
path, all with ``--device cpu``. Every name in the model registry builds the
contract-size FiT (hidden 96, 6 heads, depth 2)."""

import io
import json
import os
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import fit_tpu_torch.cli.sample as cli_sample
import fit_tpu_torch.train.loop as loop
from fit_tpu_torch.cli import demo, quantize, serve
from fit_tpu_torch.models.fit import FiT
from fit_tpu_torch.train.loop import Trainer
from fit_tpu_torch.utils.config import TrainConfig

WAIT_S = 300  # the longest a run in these tests may take


def _contract_fit(name, device="cuda", **kw):
    patch = int(name.split("/")[1])
    return FiT(patch_size=patch, hidden_size=96, depth=2, num_heads=6, device=device, **kw)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A Trainer run of 2 steps; yields its checkpoint directory with the
    registry patched for every test of the module."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    for cls in ("a", "b"):
        (root / "latents" / cls).mkdir(parents=True)
        for i in range(4):
            np.save(root / "latents" / cls / f"{i}.npy", rng.normal(size=(4, 8, 8)).astype(np.float16))
    cfg = TrainConfig(
        feature_path=str(root / "latents"), feature_val_path="", results_dir=str(root / "results"),
        model="FiT-S/2", image_size=64, num_classes=1000, epochs=1, global_batch_size=4, grad_accum=1,
        log_every=1, compute_dtype="float32", attn_backend="xla", num_workers=1,
    )
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "create_fit", _contract_fit)
        mp.setattr(cli_sample, "create_fit", _contract_fit)
        with ThreadPoolExecutor(1) as pool:
            state = pool.submit(lambda: Trainer(cfg, device="cpu").fit(max_steps=2)).result(timeout=WAIT_S)
        assert state.step == 2
        yield root, str(root / "results" / "checkpoints")


def sample(ckpt, out, *extra):
    argv = ["--device", "cpu", "--checkpoint-path", ckpt, "--num-samples", "3", "--batch-size", "2",
            "--num-sampling-steps", "2", "--image-height", "64", "--image-width", "64", "--output-dir", str(out),
            *extra]
    with ThreadPoolExecutor(1) as pool:
        return pool.submit(cli_sample.main, argv).result(timeout=WAIT_S)


def written(out):
    files = sorted(os.listdir(out), key=lambda f: int(f.split("_")[1]))
    return files, [np.load(os.path.join(out, f)) for f in files]


@pytest.mark.parametrize(
    "extra",
    [
        ["--sampler", "ddim"],
        ["--sampler", "dpm"],
        ["--sampler", "ddpm", "--image-sizes", "64x64,48x80"],
        ["--sampler", "dpm", "--dtype", "float32"],
        ["--sampler", "ddim", "--quant", "int8", "--quant-equalize", "1"],
    ],
    ids=["ddim", "dpm", "ddpm-mixed", "dpm-fp32", "int8-equalized"],
)
def test_sample_cli(trained, tmp_path, extra):
    _, ckpt = trained
    res = sample(ckpt, tmp_path / "out", *extra)
    files, arrays = written(tmp_path / "out")
    assert len(files) == 3 and len(res["seconds"]) == 2
    mixed = "--image-sizes" in extra
    shapes = [(4, 8, 8), (4, 6, 10), (4, 8, 8)] if mixed else [(4, 8, 8)] * 3
    for f, a, lat, label, shape in zip(files, arrays, res["latents"], res["labels"], shapes):
        assert f.endswith(f"_{label}.npy") and a.dtype == np.float16 and a.shape == shape
        assert np.isfinite(lat).all() and np.array_equal(a, lat.astype(np.float16))


def test_sample_cli_batches_reproduce(trained, tmp_path):
    """A batch is drawn again from its labels and generator alone: the CLI's
    second batch equals a FiTSampler run on the same EMA weights."""
    from fit_tpu_torch.sampling import FiTSampler
    from fit_tpu_torch.utils.checkpoint import CheckpointManager
    from fit_tpu_torch.utils.config import SampleConfig

    root, ckpt = trained
    res = sample(ckpt, tmp_path / "out", "--sampler", "dpm", "--global-seed", "5")
    labels, gen = cli_sample.batch_draws(5, 1, 1, 1000, "cpu")
    assert labels == res["labels"][2:]
    model = _contract_fit("FiT-S/2", device="cpu", num_classes=1000, dtype=torch.bfloat16)
    payload, _ = CheckpointManager(ckpt).restore()
    model.load_state_dict(payload["ema"])
    cfg = SampleConfig()
    want = FiTSampler(model, num_sampling_steps=2, sampler="dpm", cfg_scale=cfg.cfg_scale, device="cpu").sample(
        labels, 64, 64, generator=gen
    )
    np.testing.assert_array_equal(res["latents"][2], want[0].numpy())
    assert json.loads((root / "results" / "config.json").read_text())["num_classes"] == 1000


def test_quantize_cli_artifact_loads_in_sample(trained, tmp_path):
    _, ckpt = trained
    art = str(tmp_path / "art")
    with ThreadPoolExecutor(1) as pool:
        pool.submit(quantize.main, ["--device", "cpu", "--checkpoint-path", ckpt, "--output", art,
                                    "--equalize", "1", "--image-height", "64"]).result(timeout=WAIT_S)
    meta = json.loads(open(os.path.join(art, "quant.json")).read())
    cfg = json.loads(open(os.path.join(art, "config.json")).read())
    assert meta["equalized_batches"] == 1 and meta["scheme"] == "w8a8-int8" and cfg["num_classes"] == 1000
    model = cli_sample.load_model_and_params(_cfg(art), device="cpu")
    assert model.quant == "int8" and model.blocks[0].attn.qkv.weight.dtype == torch.int8
    res = sample(art, tmp_path / "out", "--sampler", "dpm")
    assert all(np.isfinite(lat).all() for lat in res["latents"])


def _cfg(path):
    from fit_tpu_torch.utils.config import SampleConfig

    cfg = json.loads(open(os.path.join(path, "config.json")).read())
    return SampleConfig(**{**cfg, "checkpoint_path": path})


def test_demo_cli(trained, tmp_path):
    _, ckpt = trained
    out = str(tmp_path / "demo.png")
    with ThreadPoolExecutor(1) as pool:
        lat = pool.submit(demo.main, ["--checkpoint_path", ckpt, "--model", "FiT-S/2", "--num_sampling_steps", "2",
                                      "--image_size", "64", "--out", out, "--device", "cpu"]).result(timeout=WAIT_S)
    saved = np.load(str(tmp_path / "demo_latents.npy"))
    assert saved.shape == (8, 4, 8, 8) and np.isfinite(saved).all() and np.array_equal(saved, lat)


def test_sample_cli_from_a_reference_checkpoint(trained, tmp_path):
    """A synthetic reference Lightning checkpoint whose EMA (in the
    optimizer state) differs from its weights: the CLI samples the EMA."""
    _, ckpt = trained
    model = _contract_fit("FiT-S/2", device="cpu", num_classes=1000)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(1))
    names = {"t_embedder.fc1.": "t_embedder.mlp.0.", "t_embedder.fc2.": "t_embedder.mlp.2.",
             "y_embedder.table.": "y_embedder.embedding_table.", "final.adaLN.": "final_layer.adaLN_modulation.1.",
             "final.linear.": "final_layer.linear."}

    def ref_name(k):
        for a, b in names.items():
            if k.startswith(a):
                return b + k[len(a):]
        return k.replace(".adaLN.", ".adaLN_modulation.1.")

    sd = {f"model.{ref_name(k)}": v for k, v in model.state_dict().items()}
    ema = [v * 0.5 for v in sd.values()]
    path = tmp_path / "last.ckpt"
    torch.save({"state_dict": sd, "optimizer_states": [{"ema": ema}]}, path)
    args = ("--torch-checkpoint", str(path), "--model", "FiT-S/2", "--num-classes", "1000", "--sampler", "dpm")
    res = sample("", tmp_path / "out", *args)
    res_raw = sample("", tmp_path / "raw", *args, "--use-ema", "false")
    assert all(np.isfinite(lat).all() for lat in res["latents"])
    assert not np.array_equal(res["latents"][0], res_raw["latents"][0])


def test_serve_cli_builds_and_answers(trained, tmp_path):
    _, ckpt = trained
    art = str(tmp_path / "art")
    with ThreadPoolExecutor(1) as pool:
        pool.submit(quantize.main, ["--device", "cpu", "--checkpoint-path", ckpt, "--output", art]).result(
            timeout=WAIT_S)
    httpd, server = serve.build(["--device", "cpu", "--checkpoint-path", art, "--port", "0", "--sampler", "dpm",
                                 "--num-sampling-steps", "2", "--serve-batch-size", "2", "--no-warmup"])
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        body = json.dumps({"label": 7, "height": 64, "width": 48, "seed": 3}).encode()
        with urllib.request.urlopen(urllib.request.Request(f"{base}/sample", data=body), timeout=WAIT_S) as r:
            assert r.status == 200
            lat = np.load(io.BytesIO(r.read()))
        with urllib.request.urlopen(f"{base}/stats", timeout=WAIT_S) as r:
            stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        thread.join(timeout=60)
    assert lat.shape == (4, 8, 6) and lat.dtype == np.float32 and np.isfinite(lat).all()
    assert stats["served"] == 1 and server.sampler.sampler == "dpm" and server.model.quant == "int8"


def test_missing_checkpoints_raise(tmp_path):
    missing = str(tmp_path / "nowhere")
    with pytest.raises(FileNotFoundError, match="no checkpoint directory"):
        sample(missing, tmp_path / "out")
    assert not os.path.exists(missing)  # nothing was created on the way
    os.makedirs(missing)
    with pytest.raises(FileNotFoundError, match="no checkpoint under"):
        sample(missing, tmp_path / "out")
    with pytest.raises(FileNotFoundError, match="no checkpoint file"):
        sample("", tmp_path / "out", "--torch-checkpoint", str(tmp_path / "none.ckpt"))


@pytest.mark.parametrize("entry", ["sample", "quantize", "serve", "demo"])
def test_default_device_without_a_card_raises(tmp_path, entry):
    if torch.cuda.is_available():
        pytest.skip("there is a card: the default device is usable")
    ckpt = ["--checkpoint-path", str(tmp_path)]
    run = {
        "sample": lambda: cli_sample.main(ckpt + ["--output-dir", str(tmp_path / "o")]),
        "quantize": lambda: quantize.main(ckpt + ["--output", str(tmp_path / "a")]),
        "serve": lambda: serve.build(ckpt + ["--no-warmup"]),
        "demo": lambda: demo.main(["--checkpoint_path", str(tmp_path)]),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run()


def test_sample_config_is_fit_tpus_less_tpu_and_vae_fields(tmp_path):
    """The same fields and defaults as fit_tpu's SampleConfig but for the
    TPU-only attn_backend and scan_blocks (the VAE's vae is ported); a
    fit_tpu config.json (those keys included) restores, and flags override
    it."""
    import dataclasses

    from fit_tpu.utils.config import SampleConfig as JaxSampleConfig
    from fit_tpu_torch.utils.config import SampleConfig

    ours = {f.name: f.default for f in dataclasses.fields(SampleConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxSampleConfig)}
    assert ours == {k: v for k, v in theirs.items() if k not in ("attn_backend", "scan_blocks")}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(dataclasses.asdict(JaxSampleConfig(model="FiT-XL/2", sampler="dpm"))))
    import argparse

    args, cfg = cli_sample.read_config(argparse.ArgumentParser(), ["--config", str(path), "--cfg-scale", "4.0"])
    assert (cfg.model, cfg.sampler, cfg.cfg_scale, args.device) == ("FiT-XL/2", "dpm", 4.0, "cuda")
