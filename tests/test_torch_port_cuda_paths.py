"""Paths through whole models, the Trainer and the command lines on the
card, held against the same paths through the kernels' plain versions and
counted launch by launch. These tests need a CUDA card and skip elsewhere;
like ``test_torch_port_cuda.py`` the file imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py tests/test_torch_port_cuda_paths.py -q

Sizes: where a block's kernels are the point, a model at its published
widths cut to 2 blocks (a launch count is a count a block times the depth);
where a command line needs a name from the registry, FiT-S/2, its smallest
(depth 12); the VAE in the SD layout at small widths (8, 16, 16, 16), whose
SD widths ``test_torch_port_cuda.py`` holds.

Bars, as ``test_torch_port_cuda.py``'s:
- a guided bf16 or int8 forward through the kernels within 5e-2 relative
  RMS of the same forward through their plain versions; one int8 block's
  update in fp32 within 1e-2 (a sum taken in another order can tip a value
  across an int8 rounding boundary);
- a training loss through the kernels within 1e-2 (bf16) or 1e-4 (fp32) of
  the plain one, relative, the flat gradients' cosine at least 0.99 or
  0.9999 and their norms within 5e-2 or 1e-3;
- the Trainer's resumed loss stream within 1e-6 of the straight run's;
- ``cli.sample``'s latents bit for bit ``FiTSampler``'s on the same
  weights, labels and generator, its PNGs within one uint8 step of a direct
  decode of its latents; a served seed repeated in another batch bit for bit
  under DPM-Solver++ (1e-3 under DDIM); a served image byte-equal to a
  decode of the latent the server decoded for it.
"""

import io
import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_port_cuda import bf16_ulps, cuda_device, launched, seeded_inception_state  # noqa: F401 — fixture

from fit_tpu_torch.ops import launch_counts, reset_launches

ROOT = Path(__file__).resolve().parents[1]
MIXED_SIZES = [(256, 256), (224, 288), (192, 320), (256, 224)]
FORWARD_REL_RMS = 5e-2
# a training loss through the kernels vs plain: (loss rel, min grad cosine, grad norm rel)
STEP_BARS = {torch.bfloat16: (1e-2, 0.99, 5e-2), torch.float32: (1e-4, 0.9999, 1e-3)}
TRAIN_LATENTS = [(4, 32, 32), (4, 28, 36), (4, 24, 40), (4, 36, 28)]  # within 256 tokens at patch 2
S2_DEPTH, STEPS = 12, 4  # the command lines' FiT-S/2 and sampling steps
PROCESS_S = 600  # the longest a command line's process may take


def seeded(model, seed):
    """Every parameter drawn N(0, 0.02): the reference init zeroes adaLN
    and the final layer, which would leave the blocks without signal."""
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    return model


def xl_blocks(**kw):
    """A bf16 FiT at XL/2's widths (1152, 16 heads of 72), 2 blocks."""
    from fit_tpu_torch.models.fit import FiT

    return seeded(FiT(hidden_size=1152, depth=2, num_heads=16, dtype=torch.bfloat16, device="cuda", **kw), 0)


def float_glue(forwards, depth=2, swiglu=True):
    """The row glue's launches in ``forwards`` float forwards without grad:
    K5 for each block's attention LayerNorm and the final layer's, K5R for
    each block's attention residual and FFN LayerNorm, K6 for each SwiGLU
    product (none in a GELU MLP)."""
    return {"adaln_modulate": (depth + 1) * forwards, "adaln_residual": depth * forwards,
            "swiglu_glue": depth * forwards if swiglu else 0}


def rel_rms(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).pow(2).mean() / want.pow(2).mean()).sqrt().item()


def guided_inputs(embed_dim, sizes, gen, method="rotate"):
    """One guided forward's inputs at these image sizes: RoPE tables
    (``embed_dim`` the head dim) or sin-cos tables (``method="absolute"``,
    ``embed_dim`` the hidden size), prefix masks on a T 256 canvas."""
    from fit_tpu_torch.sampling import create_pos_embed

    n = len(sizes)
    pos = torch.zeros((n, 256, embed_dim))
    mask = torch.zeros((n, 256), dtype=torch.bool)
    for i, (ih, iw) in enumerate(sizes):
        tab, valid_t = create_pos_embed(ih // 8, iw // 8, 2, 256, embed_dim, method)
        pos[i] = torch.from_numpy(tab[0])
        mask[i, :valid_t] = True
    x = torch.randn((2 * n, 4, 32, 32), generator=gen, device="cuda")
    y = torch.cat([torch.arange(n, device="cuda"), torch.full((n,), 1000, device="cuda")])
    return x, torch.full((2 * n,), 500, device="cuda"), y, torch.cat([pos, pos]).cuda(), torch.cat([mask, mask]).cuda()


def guided_forward(model, inputs, plain=False, cfg_scale=1.5):
    """One guided forward, through the kernels or their plain versions."""
    model.plain_kernels = plain
    try:
        with torch.inference_mode():
            out = model.forward_with_cfg(*inputs, cfg_scale)
    finally:
        model.plain_kernels = False
    assert torch.isfinite(out).all()
    return out


# -- sampling, int8 and serving ---------------------------------------------


@pytest.mark.cuda
def test_sampling_launches_each_kernel_once_a_block_a_step(cuda_device):
    """``FiTSampler``'s DDIM over a batch at 256^2 and over four aspect
    ratios (``sample_mixed``): each step's guided forward launches K1, K5R
    and K6 once a block and K5 once a block and for the final layer."""
    from fit_tpu_torch.sampling import FiTSampler

    sampler = FiTSampler(xl_blocks(), num_sampling_steps=3, cfg_scale=1.5, sampler="ddim", device=cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(1)
    reset_launches()
    latents = sampler.sample([0, 125, 250, 375], 256, 256, generator=gen)
    mixed = sampler.sample_mixed([0, 125, 250, 375], MIXED_SIZES, generator=gen)
    torch.cuda.synchronize()
    assert launch_counts() == launched(rope_attention_fwd=2 * 3 * 2, rope_attention_rotate_k=2 * 3 * 2, **float_glue(3 * 2))
    assert tuple(latents.shape) == (4, 4, 32, 32) and torch.isfinite(latents).all()
    assert [tuple(m.shape) for m in mixed] == [(4, h // 8, w // 8) for h, w in MIXED_SIZES]
    assert all(torch.isfinite(m).all() for m in mixed)


def int8_block_rel_rms(model, inputs, gen) -> float:
    """The relative RMS between a block's update through the kernels and
    through their plain versions, on a random hidden state at the guided
    batch's shapes."""
    from fit_tpu_torch.ops import rope_attention as ra

    _, _, _, pos, mask = inputs
    x = torch.randn((pos.shape[0], 256, model.hidden_size), generator=gen, device="cuda").to(model.dtype)
    c = torch.randn((pos.shape[0], model.hidden_size), generator=gen, device="cuda").to(model.dtype)
    cos, sin = ra.split_rope_tables(pos)
    lengths = mask.sum(-1, dtype=torch.int32)
    block = model.blocks[-1]
    with torch.inference_mode():
        got = block(x, c, cos, sin, lengths, False) - x
        want = block(x, c, cos, sin, lengths, True) - x
    assert torch.isfinite(got).all()
    return rel_rms(got, want)


@pytest.mark.cuda
def test_int8_forward_through_the_kernels_matches_plain(cuda_device):
    """The bf16 model through ``quantize_model``: one int8 block in fp32
    within 1e-2 of its plain kernels, the whole fp32 int8 forward (full and
    mixed sizes) and the bf16 one within 5e-2; a guided int8 forward
    launches K1 and K4 once a block and K3 twice."""
    from fit_tpu_torch.models.fit import FiT
    from fit_tpu_torch.ops import quant
    from fit_tpu_torch.sampling import cast_for_sampling

    qmodel = cast_for_sampling(quant.quantize_model(xl_blocks()), cuda_device)
    q32 = FiT(**{**qmodel.config, "dtype": torch.float32}, device="cuda")
    q32.load_state_dict(qmodel.state_dict())
    gen = torch.Generator(cuda_device).manual_seed(8)
    inputs = guided_inputs(qmodel.head_dim, [(256, 256)] * 8, gen)
    assert int8_block_rel_rms(q32, inputs, gen) <= 1e-2
    for sizes in ([(256, 256)] * 8, MIXED_SIZES):
        x = guided_inputs(q32.head_dim, sizes, gen)
        assert rel_rms(guided_forward(q32, x), guided_forward(q32, x, plain=True)) <= FORWARD_REL_RMS
    reset_launches()
    got = guided_forward(qmodel, inputs)
    assert launch_counts() == launched(rope_attention_fwd=2, rope_attention_rotate_k=2, adaln_quant=4, silu_mul_quant=2)
    assert rel_rms(got, guided_forward(qmodel, inputs, plain=True)) <= FORWARD_REL_RMS


FIRST_REQUEST = {"label": 3, "height": 256, "width": 256, "seed": 42}


def post_sample(base: str, body: dict):
    """POST /sample; returns (status, latent or (H, W, 3) uint8 image of an
    image/png body, or the error's text)."""
    req = urllib.request.Request(f"{base}/sample", data=json.dumps(body).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            data = resp.read()
            if resp.headers["Content-Type"] == "image/png":
                from PIL import Image

                return resp.status, np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            return resp.status, np.load(io.BytesIO(data))
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def request_burst(base: str):
    """12 seeded requests of mixed sizes: one alone in its batch, then
    eleven at once, among them the first one's seed again. Returns the
    (body, (status, output)) pairs, /stats and /healthz."""
    responses = [(FIRST_REQUEST, post_sample(base, FIRST_REQUEST))]
    burst = [{"label": 100 + 37 * i, "height": h, "width": w, "seed": 1000 + i}
             for i, (h, w) in enumerate((MIXED_SIZES * 3)[:10])]
    burst.insert(5, dict(FIRST_REQUEST))
    with ThreadPoolExecutor(len(burst)) as pool:
        responses += list(zip(burst, pool.map(lambda b: post_sample(base, b), burst)))
    with urllib.request.urlopen(f"{base}/stats", timeout=60) as resp:
        stats = json.loads(resp.read())
    with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
        health = json.loads(resp.read())
    return responses, stats, health


def check_burst(responses, stats, health, pixels=False) -> float:
    """Every response a 200 with a finite latent (``pixels``: a PNG) of its
    size and every request served; returns the repeated seed's max
    |difference|."""
    for body, (status, out) in responses:
        assert status == 200, (body, out)
        want = (body["height"], body["width"], 3) if pixels else (4, body["height"] // 8, body["width"] // 8)
        assert tuple(out.shape) == want and out.dtype == (np.uint8 if pixels else np.float32), body
        assert np.isfinite(out).all()
    assert health == {"status": "ok"} and stats["served"] == len(responses)
    repeat = [out.astype(np.float64) for body, (_, out) in responses if body == FIRST_REQUEST]
    return float(np.abs(repeat[0] - repeat[1]).max())


@pytest.mark.cuda
def test_int8_serving_over_http_on_the_card(cuda_device):
    """``SamplingServer`` behind the HTTP handler on 127.0.0.1 with the int8
    model, DDIM: 12 requests answered, a seed repeated in another batch
    within 1e-3, and every batch's steps launching K1 and K4 once a block
    and K3 twice."""
    from fit_tpu_torch.cli.serve import make_handler
    from fit_tpu_torch.ops import quant
    from fit_tpu_torch.sampling import cast_for_sampling
    from fit_tpu_torch.serve import SamplingServer

    qmodel = cast_for_sampling(quant.quantize_model(xl_blocks()), cuda_device)
    server = SamplingServer(qmodel, batch_size=8, max_batch_wait_s=0.1, num_sampling_steps=STEPS, cfg_scale=1.5,
                            sampler="ddim", device=cuda_device)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        server.warmup(timeout=PROCESS_S)
        reset_launches()
        responses, stats, health = request_burst(f"http://127.0.0.1:{httpd.server_address[1]}")
        counts = launch_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        thread.join(timeout=60)
    assert check_burst(responses, stats, health) <= 1e-3
    forwards = STEPS * stats["batches"]
    assert counts == launched(rope_attention_fwd=2 * forwards, rope_attention_rotate_k=2 * forwards,
                               adaln_quant=4 * forwards, silu_mul_quant=2 * forwards)


@pytest.mark.cuda
def test_served_images_are_the_decodes_of_their_own_latents(cuda_device):
    """``SamplingServer`` with a bf16 VAE and DPM-Solver++, 14 requests of
    four sizes in batches of up to 4 that follow each other on the card:
    each request's uint8 image is byte-equal to ``to_uint8(vae.decode(z))``
    of the latent ``z`` the server decoded for it, decoded again after the
    server closed. The completer reads a batch's pinned copies only once
    the event behind them has fired."""
    from fit_tpu_torch.serve import SamplingServer
    from fit_tpu_torch.vae import AutoencoderKL
    from fit_tpu_torch.vae.model import to_uint8

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(10)
        vae = AutoencoderKL((8, 16, 16, 16), dtype=torch.bfloat16, device=cuda_device)
    decode, latents = vae.decode, []

    def keeping(z):  # the worker's decodes, in request order
        latents.append(z.clone())
        return decode(z)

    vae.decode = keeping
    sizes = [MIXED_SIZES[i % len(MIXED_SIZES)] for i in range(14)]
    with SamplingServer(xl_blocks(), batch_size=4, max_batch_wait_s=0.0, num_sampling_steps=STEPS, cfg_scale=1.5,
                        sampler="dpm", device=cuda_device, vae=vae) as srv:
        futs = [srv.submit(i, h, w, seed=100 + i) for i, (h, w) in enumerate(sizes)]
        images = [f.result(timeout=PROCESS_S) for f in futs]
        stats = srv.stats()
    vae.decode = decode
    assert stats["served"] == len(latents) == 14 and stats["batches"] >= 4
    with torch.inference_mode():
        for (h, w), z, image in zip(sizes, latents, images):
            assert image.shape == (h, w, 3) and image.dtype == np.uint8
            np.testing.assert_array_equal(image, to_uint8(decode(z)[0]))


# -- training ---------------------------------------------------------------


def b2_blocks(dtype, **kw):
    """A FiT at FiT-B/2's widths (768, 12 heads of 64), 2 blocks."""
    from fit_tpu_torch.models.fit import FiT

    return seeded(FiT(hidden_size=768, depth=2, num_heads=12, dtype=dtype, device="cuda", **kw), 6)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "fp32", "learn-sigma"])
def test_b2_training_through_the_kernels_matches_plain(cuda_device, kind):
    """One training loss of a micro-batch of 16 x T 256, forward and
    backward through the kernels against the same through their plain
    versions, on the same weights, inputs and noise. "bf16" and "fp32":
    ``diffusion_loss`` over padded rows of four aspect ratios with remat (K1
    twice a block, K2 once); "learn-sigma": a learned-range loss (mse + vb)
    over full rows without remat (K1 and K2 once a block)."""
    from fit_tpu_torch.core.pos_embed import rope_freqs_2d
    from fit_tpu_torch.diffusion.gaussian import create_diffusion
    from fit_tpu_torch.train.step import diffusion_loss

    dtype = torch.float32 if kind == "fp32" else torch.bfloat16
    gen = torch.Generator(cuda_device).manual_seed(6)
    n, t = 16, 256
    if kind == "learn-sigma":
        model = b2_blocks(dtype, learn_sigma=True)
        x0, noise = (torch.randn((n, 4, 32, 32), generator=gen, device="cuda") for _ in range(2))
        ts, y = (torch.randint(0, 1000, (n,), generator=gen, device="cuda") for _ in range(2))
        pos = torch.from_numpy(rope_freqs_2d(model.head_dim, 16, 16)).cuda().expand(n, -1, -1).contiguous()
        lengths = torch.full((n,), t, dtype=torch.int32, device="cuda")
        diffusion = create_diffusion(None, learn_sigma=True, rescale_learned_sigmas=True)

        def loss_fn():
            forward = lambda x, s: model(x, s, y, pos, None, train=False, lengths=lengths)  # noqa: E731
            return diffusion.training_losses(forward, x0, ts, noise)["loss"].mean()

        per_run = launched(rope_attention_fwd=2, rope_attention_bwd=2, rope_attention_rotate_k=2)
    else:
        model = b2_blocks(dtype, remat=True)
        pos = torch.zeros((n, t, model.head_dim))
        mask = torch.zeros((n, t), dtype=torch.bool)
        for i in range(n):
            _, h, w = TRAIN_LATENTS[i % len(TRAIN_LATENTS)]
            tab = torch.from_numpy(rope_freqs_2d(model.head_dim, h // 2, w // 2))
            pos[i, : len(tab)], mask[i, : len(tab)] = tab, True
        mask = mask.cuda()
        batch = {
            "tokens": torch.randn((n, t, 16), generator=gen, device="cuda") * mask[..., None],
            "pos": pos.cuda(), "mask": mask, "lengths": mask.sum(-1, dtype=torch.int32),
            "label": torch.randint(0, 1000, (n,), generator=gen, device="cuda"),
            "t": torch.randint(0, 1000, (n,), generator=gen, device="cuda"),
            "noise": torch.randn((n, t, 16), generator=gen, device="cuda"),
            "drop_ids": (torch.rand((n,), generator=gen, device="cuda") < 0.1).int(),
        }
        diffusion = create_diffusion(None)

        def loss_fn():
            return diffusion_loss(model, diffusion, batch)[0]

        per_run = launched(rope_attention_fwd=4, rope_attention_bwd=2,
                           rope_attention_rotate_k=4 if dtype == torch.bfloat16 else 0)

    def run(plain):
        model.plain_kernels = plain
        model.zero_grad(set_to_none=True)
        reset_launches()
        loss = loss_fn()
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), torch.cat([p.grad.flatten().float() for p in model.parameters()]), launch_counts()

    try:
        (loss_k, g_k, counts_k), (loss_p, g_p, counts_p) = run(False), run(True)
    finally:
        model.plain_kernels = False
    assert counts_k == per_run and counts_p == launched()
    loss_tol, min_cos, norm_tol = STEP_BARS[dtype]
    assert np.isfinite(loss_k) and abs(loss_k - loss_p) <= loss_tol * abs(loss_p)
    assert torch.nn.functional.cosine_similarity(g_k, g_p, dim=0).item() >= min_cos
    assert abs(g_k.norm().item() - g_p.norm().item()) <= norm_tol * g_p.norm().item()


@pytest.fixture
def b2_trainer(monkeypatch):
    """The Trainer builds its model by registry name; here every name builds
    FiT-B/2's widths with 2 blocks."""
    import fit_tpu_torch.train.loop as loop
    from fit_tpu_torch.models.fit import FiT

    def create(name, device="cuda", **kw):
        return FiT(hidden_size=768, depth=2, num_heads=12, patch_size=2, device=device, **kw)

    monkeypatch.setattr(loop, "create_fit", create)


def write_train_latents(root: Path, n: int) -> None:
    """``n`` fp16 latents of TRAIN_LATENTS's shapes in two classes."""
    rng = np.random.default_rng(0)
    for i in range(n):
        d = root / f"class{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        np.save(d / f"{i}.npy", rng.normal(size=TRAIN_LATENTS[i % len(TRAIN_LATENTS)]).astype(np.float16))


def train(work: Path, name: str, latents: Path, max_steps: int, global_batch=16, **kw):
    """``Trainer.fit(max_steps)`` in 2 micro-batches, results under
    ``work / name`` (a run there before is resumed). Returns its step, the
    launch counts of the run, every logged step's loss and the Trainer."""
    from fit_tpu_torch.train.loop import Trainer
    from fit_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig(feature_path=str(latents), feature_val_path="", results_dir=str(work / name), model="FiT-B/2",
                      global_batch_size=global_batch, grad_accum=2, log_every=1, ckpt_every_epochs=100,
                      num_workers=2, **kw)
    trainer = Trainer(cfg, device="cuda")
    reset_launches()
    state = trainer.fit(max_steps=max_steps)
    torch.cuda.synchronize()
    counts = launch_counts()
    with open(work / name / "FiT-B-2_metrics.jsonl") as f:
        losses = {r["step"]: r["train_loss"] for r in map(json.loads, f) if "train_loss" in r}
    return state.step, counts, losses, trainer


@pytest.mark.cuda
def test_trainer_resumes_its_loss_stream_on_the_card(cuda_device, tmp_path, b2_trainer):
    """32 latents at global batch 16: a straight 4-step pad-packed run
    across the epoch boundary at step 2; the same stopped at step 2 and
    resumed to 4 by a fresh Trainer, whose loss stream is the straight
    run's; 2 steps of bucket packing; 2 pad-packed steps in fp32. A
    micro-batch launches K1 twice a block under remat (pad) or once
    (bucket), and K2 once."""
    write_train_latents(tmp_path / "latents", 32)
    runs = {}
    for name, start, stop, kw in [("straight", 0, 4, {}), ("split", 0, 2, {}), ("split", 2, 4, {}),
                                  ("bucket", 0, 2, {"packing": "bucket"}),
                                  ("fp32", 0, 2, {"compute_dtype": "float32"})]:
        step, counts, runs[name], _ = train(tmp_path, name, tmp_path / "latents", stop, **kw)
        k1 = (1 if name == "bucket" else 2) * 2 * 2 * (stop - start)
        rotate_k = 0 if name == "fp32" else k1  # the bf16 K1's K pre-pass
        assert step == stop and counts == launched(rope_attention_fwd=k1, rope_attention_bwd=2 * 2 * (stop - start),
                                                   rope_attention_rotate_k=rotate_k)
    assert sorted(runs["straight"]) == sorted(runs["split"]) == [1, 2, 3, 4]
    assert max(abs(runs["split"][s] - runs["straight"][s]) for s in range(1, 5)) <= 1e-6
    assert sorted(runs["bucket"]) == sorted(runs["fp32"]) == [1, 2]
    assert np.isfinite([v for r in runs.values() for v in r.values()]).all()


IMAGE_SIZES = [(256, 256), (320, 192), (192, 320), (384, 256)]  # (w, h), each within 256^2 after resize


def write_image_tree(root: Path, n: int, seed: int, sizes=IMAGE_SIZES) -> dict:
    """``n`` smooth random RGB PNGs in two class folders, cycling over
    ``sizes``. Returns {relative latent path: (w, h)}."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    shapes = {}
    for i in range(n):
        w, h = sizes[i % len(sizes)]
        coarse = rng.integers(0, 256, size=(h // 32 + 1, w // 32 + 1, 3), dtype=np.uint8)
        img = np.asarray(Image.fromarray(coarse).resize((w, h), resample=Image.BICUBIC), dtype=np.int16)
        img = np.clip(img + rng.integers(-8, 9, size=img.shape), 0, 255).astype(np.uint8)
        rel = Path(f"class{i % 2}") / f"{i}.png"
        (root / rel.parent).mkdir(parents=True, exist_ok=True)
        Image.fromarray(img).save(root / rel)
        shapes[str(rel.with_suffix(".npy"))] = (w, h)
    return shapes


def write_vae_dir(vae_dir: Path) -> Path:
    """A VAE in the SD layout at widths (8, 16, 16, 16), PyTorch's default
    init from seed 10, as the diffusers checkpoint ``sd-vae-ft-ema.bin``."""
    from fit_tpu_torch.vae import AutoencoderKL
    from fit_tpu_torch.vae.convert import to_diffusers_state_dict

    blocks = (8, 16, 16, 16)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(10)
        state = AutoencoderKL(blocks, device="cpu").state_dict()
    vae_dir.mkdir(parents=True, exist_ok=True)
    torch.save(to_diffusers_state_dict(state, blocks), vae_dir / "sd-vae-ft-ema.bin")
    return vae_dir


def run_module(module: str, args) -> str:
    """``python -m <module> <args>`` from the repository's root; its stdout.
    Fails unless it exits 0."""
    proc = subprocess.run([sys.executable, "-m", module, *map(str, args)], cwd=ROOT, capture_output=True, text=True,
                          timeout=PROCESS_S)
    assert proc.returncode == 0, f"{module} exited {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-3000:]}"
    return proc.stdout


@pytest.mark.cuda
def test_preprocessed_images_train_the_mlp_trainer_on_the_card(cuda_device, tmp_path, b2_trainer):
    """``cli.preprocess`` as a process encodes 8 images of four aspect
    ratios into fp16 latents of ``resize_dims`` / 8, and the Trainer with
    ``ffn="mlp"`` takes 2 steps on exactly those latents (K1 twice a block
    a micro-batch under remat, K2 once)."""
    from fit_tpu_torch.data.preprocess import resize_dims
    from fit_tpu_torch.models.layers import GeluMlp

    shapes = write_image_tree(tmp_path / "imgs", 8, seed=3)
    lat_dir = tmp_path / "latents"
    run_module("fit_tpu_torch.cli.preprocess", ["--dataset-path", tmp_path / "imgs", "--latent-folder", lat_dir,
                                                "--vae-checkpoint", write_vae_dir(tmp_path / "vae"),
                                                "--batch-size", 4, "--device", "cuda"])
    got = {str(p.relative_to(lat_dir)): np.load(p) for p in lat_dir.rglob("*.npy")}
    assert {k: v.shape for k, v in got.items()} == {
        k: (4, resize_dims(w, h)[1] // 8, resize_dims(w, h)[0] // 8) for k, (w, h) in shapes.items()}
    assert (lat_dir / "path.json").exists()
    assert all(v.dtype == np.float16 and np.isfinite(v).all() for v in got.values())
    step, counts, losses, trainer = train(tmp_path, "mlp", lat_dir, 2, global_batch=8, ffn="mlp")
    assert all(isinstance(blk.ffn, GeluMlp) for blk in trainer.model.blocks)
    assert step == 2 and sorted(losses) == [1, 2] and np.isfinite(list(losses.values())).all()
    assert counts == launched(rope_attention_fwd=2 * 2 * 2 * 2, rope_attention_bwd=2 * 2 * 2,
                               rope_attention_rotate_k=2 * 2 * 2 * 2)


# -- DiT and FiT's other modes ------------------------------------------------


@pytest.mark.cuda
def test_dit_sampling_through_the_kernels_on_the_card(cuda_device):
    """DiT at XL/2's widths, 2 blocks, at 512^2 (64 x 64 latents, T 1024):
    a guided forward (CFG 4.0) through K1 with RoPE off against the plain
    kernels, and DDPM with a learned range, 3 steps at batch 2 with CFG,
    each step's forward launching K1 (``masked_attention``) and K5R once a
    block and K5 once a block and for the final layer (no K6: a GELU MLP)."""
    from fit_tpu_torch.diffusion.gaussian import create_diffusion
    from fit_tpu_torch.diffusion.samplers import p_sample_loop
    from fit_tpu_torch.models.dit import DiT
    from fit_tpu_torch.sampling import cast_for_sampling

    model = cast_for_sampling(seeded(DiT(input_size=64, depth=2, dtype=torch.bfloat16, device="cuda"), 7), cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(7)
    y = torch.tensor([1, 2, 1000, 1000], device="cuda")
    x = torch.randn((2, 4, 64, 64), generator=gen, device="cuda")
    inputs = (torch.cat([x, x]), torch.full((4,), 500, device="cuda"), y)
    got = guided_forward(model, inputs, cfg_scale=4.0)
    assert rel_rms(got, guided_forward(model, inputs, plain=True, cfg_scale=4.0)) <= FORWARD_REL_RMS
    diffusion = create_diffusion("3", learn_sigma=True)
    z = torch.randn((2, 4, 64, 64), generator=gen, device="cuda")
    reset_launches()
    with torch.inference_mode():
        latents = p_sample_loop(diffusion, lambda xt, t: model.forward_with_cfg(xt, t, y, 4.0), torch.cat([z, z]),
                                gen, clip_denoised=False)[:2]
    torch.cuda.synchronize()
    assert launch_counts() == launched(masked_attention=2 * 3, **float_glue(3, swiglu=False))
    assert tuple(latents.shape) == (2, 4, 64, 64) and torch.isfinite(latents).all()


@pytest.mark.cuda
def test_fit_absolute_mlp_forward_through_the_kernels_matches_plain(cuda_device):
    """FiT with ``pos_kind="absolute"`` and ``ffn="mlp"`` over four aspect
    ratios (prefix masks): a guided forward through the kernels against
    their plain versions."""
    from fit_tpu_torch.sampling import cast_for_sampling

    model = cast_for_sampling(xl_blocks(pos_kind="absolute", ffn="mlp"), cuda_device)
    inputs = guided_inputs(model.hidden_size, MIXED_SIZES, torch.Generator(cuda_device).manual_seed(8), "absolute")
    assert rel_rms(guided_forward(model, inputs), guided_forward(model, inputs, plain=True)) <= FORWARD_REL_RMS


# -- the command lines ------------------------------------------------------


_REFERENCE_NAMES = (
    ("t_embedder.fc1.", "t_embedder.mlp.0."), ("t_embedder.fc2.", "t_embedder.mlp.2."),
    ("y_embedder.table.", "y_embedder.embedding_table."),
    ("final.adaLN.", "final_layer.adaLN_modulation.1."), ("final.linear.", "final_layer.linear."),
)


def reference_key(name: str) -> str:
    """A port state-dict key -> the reference Lightning module's."""
    for port, ref in _REFERENCE_NAMES:
        if name.startswith(port):
            return "model." + ref + name[len(port):]
    return "model." + name.replace(".adaLN.", ".adaLN_modulation.1.")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """A reference (PyTorch Lightning) checkpoint of FiT-S/2 with seeded
    weights and, in its optimizer state, an EMA copy at half of them (a load
    of the wrong copy shows), and a VAE directory. Returns (the checkpoint,
    the EMA state dict, the VAE directory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from fit_tpu_torch.models.fit import create_fit

    root = tmp_path_factory.mktemp("cli")
    weights = {k: v.detach().cpu() for k, v in seeded(create_fit("FiT-S/2", dtype=torch.bfloat16, device="cuda"), 0).state_dict().items()}
    ema = {k: v * 0.5 for k, v in weights.items()}
    torch.save({"state_dict": {reference_key(k): v for k, v in weights.items()},
                "optimizer_states": [{"ema": list(ema.values())}], "epoch": 0, "global_step": 0}, root / "last.ckpt")
    return root / "last.ckpt", ema, write_vae_dir(root / "vae")


def cli_args(ckpt: Path, n: int = 4) -> list:
    return ["--model", "FiT-S/2", "--num-sampling-steps", str(STEPS), "--cfg-scale", "1.5", "--num-samples", str(n),
            "--batch-size", str(n), "--image-height", "256", "--image-width", "256", "--device", "cuda",
            "--torch-checkpoint", str(ckpt)]


def in_process(main, argv):
    """``main(argv)`` and the launch counts of its run."""
    reset_launches()
    out = main(argv)
    torch.cuda.synchronize()
    return out, launch_counts()


def pngs(out_dir: Path) -> list:
    """The (H, W, 3) pixels of ``generated_image_<i>_*.png``, by i."""
    from PIL import Image

    files = sorted(out_dir.glob("generated_image_*.png"), key=lambda f: int(f.name.split("_")[2]))
    return [np.asarray(Image.open(f).convert("RGB")) for f in files]


def uint8_steps(a, b) -> int:
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dpm", "ddim-mixed", "fp32"])
def test_cli_sample_on_the_card(cuda_device, reference, tmp_path, kind):
    """``cli.sample`` of the reference checkpoint's EMA, in process; each
    step's guided forward launches K1, K5R and K6 once a block and K5 once
    a block and for the final layer. "dpm": the latents bit for bit
    ``FiTSampler``'s on the EMA weights with the CLI's labels and generator;
    "ddim-mixed": packed over four sizes, each latent at its size; with
    ``--vae-checkpoint`` both write the same latents and PNGs within one
    uint8 step of their direct bf16 decode. "fp32": ``--dtype float32``."""
    from fit_tpu_torch.cli import sample as cli_sample
    from fit_tpu_torch.models.fit import create_fit
    from fit_tpu_torch.sampling import FiTSampler
    from fit_tpu_torch.utils.config import SampleConfig
    from fit_tpu_torch.vae import load_autoencoder, to_uint8

    ckpt, ema, vae_dir = reference
    extra = {"dpm": ["--sampler", "dpm"],
             "ddim-mixed": ["--sampler", "ddim", "--image-sizes", ",".join(f"{h}x{w}" for h, w in MIXED_SIZES)],
             "fp32": ["--sampler", "ddim", "--dtype", "float32"]}[kind]
    argv = cli_args(ckpt) + extra
    rotate_k = 0 if kind == "fp32" else S2_DEPTH * STEPS  # the bf16 K1's K pre-pass
    forwards = launched(rope_attention_fwd=S2_DEPTH * STEPS, rope_attention_rotate_k=rotate_k,
                        **float_glue(STEPS, S2_DEPTH))
    res, counts = in_process(cli_sample.main, argv + ["--output-dir", str(tmp_path / "latents")])
    assert counts == forwards and all(np.isfinite(lat).all() for lat in res["latents"])
    if kind == "fp32":
        return
    if kind == "dpm":
        cfg = SampleConfig(model="FiT-S/2", num_sampling_steps=STEPS, cfg_scale=1.5)
        loaded = cli_sample.load_model_and_params(cfg, torch_checkpoint=str(ckpt), device="cuda")
        assert all(torch.equal(v.cpu(), ema[k]) for k, v in loaded.state_dict().items())
        model = create_fit("FiT-S/2", dtype=torch.bfloat16, device="cuda")
        model.load_state_dict(ema)
        labels, generator = cli_sample.batch_draws(cfg.global_seed, 0, 4, cfg.num_classes, cuda_device)
        want = FiTSampler(model, num_sampling_steps=STEPS, cfg_scale=1.5, sampler="dpm", device=cuda_device).sample(
            labels, 256, 256, generator=generator)
        assert res["labels"] == labels and np.array_equal(np.stack(res["latents"]), want.cpu().numpy())
    else:
        assert [lat.shape for lat in res["latents"]] == [(4, h // 8, w // 8) for h, w in MIXED_SIZES]
    png, counts = in_process(cli_sample.main, argv + ["--vae-checkpoint", str(vae_dir),
                                                      "--output-dir", str(tmp_path / "png")])
    assert counts == forwards
    assert all(np.array_equal(a, b) for a, b in zip(res["latents"], png["latents"]))
    vae = load_autoencoder(str(vae_dir), "ema", dtype=torch.bfloat16, device="cuda")
    images = pngs(tmp_path / "png")
    assert [im.shape for im in images] == [(8 * lat.shape[1], 8 * lat.shape[2], 3) for lat in res["latents"]]
    with torch.inference_mode():
        direct = [to_uint8(vae.decode(torch.from_numpy(lat)[None].cuda()))[0] for lat in res["latents"]]
    assert max(uint8_steps(im, d) for im, d in zip(images, direct)) <= 1


@pytest.fixture(scope="module")
def artifact(reference, tmp_path_factory):
    """``cli.quantize --equalize 2`` of the reference checkpoint: the int8
    artifact's directory and the launch counts of its run."""
    from fit_tpu_torch.cli import quantize

    art = tmp_path_factory.mktemp("int8") / "art"
    _, counts = in_process(quantize.main, cli_args(reference[0]) + ["--output", str(art), "--equalize", "2"])
    return art, counts


@pytest.mark.cuda
def test_cli_quantize_and_the_int8_artifact_on_the_card(cuda_device, reference, artifact, tmp_path):
    """``cli.quantize`` without and with SmoothQuant on 2 calibration
    batches (a float guided forward each); the equalized artifact's guided
    int8 forward against the plain kernels, and the equalized bf16 model
    against the unequalized one; ``cli.sample`` and ``cli.demo
    --vae-checkpoint`` (a 512 x 1024 grid of 8) from the artifact, each
    forward launching K1 and K4 once a block and K3 twice."""
    from fit_tpu_torch.cli import demo as cli_demo
    from fit_tpu_torch.cli import quantize as cli_quantize
    from fit_tpu_torch.cli import sample as cli_sample
    from fit_tpu_torch.models.fit import create_fit
    from fit_tpu_torch.ops.equalize import calibrate, equalize_params, synthetic_calib_batch
    from fit_tpu_torch.sampling import cast_for_sampling
    from fit_tpu_torch.utils.config import SampleConfig

    ckpt, _, vae_dir = reference
    art, counts = artifact
    assert counts == launched(rope_attention_fwd=2 * S2_DEPTH, rope_attention_rotate_k=2 * S2_DEPTH,
                               **float_glue(2, S2_DEPTH))
    _, counts = in_process(cli_quantize.main, cli_args(ckpt) + ["--output", str(tmp_path / "int8")])
    assert counts == launched()
    qcfg = SampleConfig(**{**json.loads((art / "config.json").read_text()), "checkpoint_path": str(art)})
    qmodel = cast_for_sampling(cli_sample.load_model_and_params(qcfg, device="cuda"), cuda_device)
    inputs = guided_inputs(qmodel.head_dim, [(256, 256)] * 4, torch.Generator(cuda_device).manual_seed(8))
    assert rel_rms(guided_forward(qmodel, inputs), guided_forward(qmodel, inputs, plain=True)) <= FORWARD_REL_RMS
    loaded = cli_sample.load_model_and_params(SampleConfig(model="FiT-S/2"), torch_checkpoint=str(ckpt), device="cuda")
    rng = np.random.default_rng(0)
    calib = [synthetic_calib_batch(loaded, rng, batch=4, size=256) for _ in range(2)]
    eq_model = create_fit("FiT-S/2", dtype=torch.bfloat16, device="cuda")
    eq_model.load_state_dict(equalize_params(loaded.state_dict(), calibrate(loaded, calib)))
    eq_model, loaded = (cast_for_sampling(m, cuda_device) for m in (eq_model, loaded))
    assert rel_rms(guided_forward(eq_model, inputs), guided_forward(loaded, inputs)) <= FORWARD_REL_RMS

    int8 = launched(rope_attention_fwd=S2_DEPTH * STEPS, rope_attention_rotate_k=S2_DEPTH * STEPS,
                    adaln_quant=2 * S2_DEPTH * STEPS, silu_mul_quant=S2_DEPTH * STEPS)
    res, counts = in_process(cli_sample.main, ["--checkpoint-path", str(art), "--sampler", "dpm", "--device", "cuda",
                                               "--num-sampling-steps", str(STEPS), "--num-samples", "4",
                                               "--batch-size", "4", "--output-dir", str(tmp_path / "int8_out")])
    assert counts == int8 and len(res["latents"]) == 4 and all(np.isfinite(lat).all() for lat in res["latents"])
    grid = tmp_path / "demo.png"
    _, counts = in_process(cli_demo.main, ["--checkpoint_path", str(art), "--model", "FiT-S/2",
                                           "--num_sampling_steps", str(STEPS), "--image_size", "256",
                                           "--out", str(grid), "--vae-checkpoint", str(vae_dir / "sd-vae-ft-ema.bin"),
                                           "--device", "cuda"])
    from PIL import Image

    assert counts == int8 and np.asarray(Image.open(grid).convert("RGB")).shape == (512, 1024, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("pixels", [False, True], ids=["latents", "png"])
def test_cli_serve_as_a_process_on_the_card(cuda_device, reference, artifact, pixels):
    """``python -m fit_tpu_torch.cli.serve`` of the int8 artifact on
    127.0.0.1, DPM-Solver++ at batch 8 (``png``: ``--vae-checkpoint``, PNG
    bodies): 12 requests answered, a seed repeated in another batch bit for
    bit, exit 0 on SIGINT, and its printed launch counts those of its
    batches' forwards, the warm-up's included."""
    art, _ = artifact
    cmd = [sys.executable, "-m", "fit_tpu_torch.cli.serve", "--checkpoint-path", str(art), "--sampler", "dpm",
           "--num-sampling-steps", str(STEPS), "--serve-batch-size", "8", "--max-batch-wait-s", "0.1",
           "--host", "127.0.0.1", "--port", "0", "--device", "cuda"]
    if pixels:
        cmd += ["--vae-checkpoint", str(reference[2])]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "PYTHONUNBUFFERED": "1"})
    lines: "queue.Queue[str]" = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(line) for line in proc.stdout], daemon=True)
    reader.start()
    log, base, t0 = [], None, time.perf_counter()
    try:
        while base is None:
            assert time.perf_counter() - t0 < PROCESS_S and proc.poll() is None, "".join(log[-20:])
            try:
                log.append(lines.get(timeout=5))
            except queue.Empty:
                continue
            found = re.search(r"listening on (http://127\.0\.0\.1:\d+)", log[-1])
            base = found.group(1) if found else None
        responses, stats, health = request_burst(base)
        proc.send_signal(signal.SIGINT)
        code = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        reader.join(timeout=60)
    while not lines.empty():
        log.append(lines.get())
    assert code == 0, "".join(log[-20:])
    assert check_burst(responses, stats, health, pixels) == 0.0
    printed = [line for line in log if line.startswith("[serve] kernel launches: ")]
    forwards = STEPS * (stats["batches"] + 1)
    assert json.loads(printed[-1].split(": ", 1)[1]) == launched(
        rope_attention_fwd=S2_DEPTH * forwards, rope_attention_rotate_k=S2_DEPTH * forwards,
        adaln_quant=2 * S2_DEPTH * forwards, silu_mul_quant=S2_DEPTH * forwards)


METRIC_LINES = {"FID": r"^FID: (\S+)$", "sFID": r"^sFID: (\S+)$", "IS": r"^Inception Score: (\S+) \+/- (\S+)$",
                "PR": r"^Precision: (\S+)  Recall: (\S+)$"}


@pytest.mark.cuda
def test_cli_sample_pngs_scored_by_cli_fid_on_the_card(cuda_device, reference, tmp_path, capsys):
    """``python -m fit_tpu_torch.cli.sample --vae-checkpoint`` as a process
    writes 16 PNGs at 256^2 (its printed launches: one batch's forwards);
    ``cli.fid`` on the card with a seeded full-width InceptionV3 writes the
    statistics of 16 reference images and scores the samples against them:
    FID, sFID, IS and precision / recall, each finite."""
    from fit_tpu_torch.cli import fid as cli_fid

    ckpt, _, vae_dir = reference
    samples, ref_dir, stats = tmp_path / "samples", tmp_path / "reference", tmp_path / "reference_stats.npz"
    out = run_module("fit_tpu_torch.cli.sample", cli_args(ckpt, 16) + ["--sampler", "dpm", "--vae-checkpoint",
                                                                       vae_dir, "--output-dir", samples])
    printed = [line for line in out.splitlines() if line.startswith("[sample] kernel launches: ")]
    assert json.loads(printed[-1].split(": ", 1)[1]) == launched(rope_attention_fwd=S2_DEPTH * STEPS,
                                                                  rope_attention_rotate_k=S2_DEPTH * STEPS,
                                                                  **float_glue(STEPS, S2_DEPTH))
    assert [im.shape for im in pngs(samples)] == [(256, 256, 3)] * 16
    write_image_tree(ref_dir, 16, seed=12, sizes=[(256, 256)])
    weights = tmp_path / "pt_inception_seeded.pth"
    torch.save(seeded_inception_state(), weights)
    common = ["--inception-weights", str(weights), "--batch-size", "16", "--device", "cuda"]
    cli_fid.main(["--samples-dir", str(ref_dir), "--save-stats", str(stats)] + common)
    saved = np.load(stats)
    assert set(saved.files) == {"mu", "sigma", "feats", "mu_s", "sigma_s"} and saved["feats"].shape == (16, 2048)
    capsys.readouterr()
    cli_fid.main(["--samples-dir", str(samples), "--reference", str(stats), "--metrics", "fid,sfid,is,pr"] + common)
    printed = capsys.readouterr().out
    found = {k: re.search(p, printed, re.M) for k, p in METRIC_LINES.items()}
    assert all(found.values()), printed
    assert all(np.isfinite(float(g)) for m in found.values() for g in m.groups())


# -- FLUX: K8, K6G and the two-stream blocks --------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("heads,d", [(24, 128), (6, 64), (3, 32)])
def test_qk_norm_matches_plain_version(cuda_device, heads, d, dtype):
    """K8 both ways FLUX calls it: two streams' [q | k | v] rows into one
    joint buffer at row offsets 0 and 256 (v copied), and q and k normed in
    place in a single block's wider linear1 rows (v and m untouched)."""
    from fit_tpu_torch.ops import fused_adaln

    gen = torch.Generator(device=cuda_device).manual_seed(heads * d)
    c = heads * d
    b, tt, ti = 2, 256, 1024

    def randn(*shape):
        return (torch.randn(shape, generator=gen, device=cuda_device) * 2).to(dtype)

    txt, img = randn(b, tt, 3 * c), randn(b, ti, 3 * c)
    qs, ks = (1 + 0.1 * randn(d).float()).to(dtype), (1 + 0.1 * randn(d).float()).to(dtype)
    joint = torch.empty((b, tt + ti, 3 * c), device=cuda_device, dtype=dtype)
    want = torch.empty_like(joint)
    reset_launches()
    for x, row in ((txt, 0), (img, tt)):
        fused_adaln.qk_norm(x, qs, ks, heads, out=joint, row_offset=row)
        fused_adaln.qk_norm(x, qs, ks, heads, out=want, row_offset=row, plain=True)
    h1 = randn(b, tt + ti, 7 * c)
    before = h1.clone()
    fused_adaln.qk_norm(h1, qs, ks, heads)
    torch.cuda.synchronize()
    assert launch_counts() == launched(qk_norm=3)
    want_h1 = fused_adaln.qk_norm(before.clone(), qs, ks, heads, plain=True)
    assert torch.equal(joint[..., 2 * c :], want[..., 2 * c :]) and torch.equal(h1[..., 2 * c :], before[..., 2 * c :])
    for got, ref in ((joint, want), (h1[..., : 2 * c], want_h1[..., : 2 * c])):
        if dtype == torch.bfloat16:
            assert bf16_ulps(got, ref) <= 1
        else:
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        fused_adaln.qk_norm(txt[..., 1:], qs, ks, heads, out=joint)  # a base off the 16-byte grid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,width", [(4352, 12288), (5, 8)])
def test_gelu_glue_matches_plain_version(cuda_device, rows, width, dtype):
    """K6G from the m columns of a single block's linear1 rows into the
    columns after the attention's in linear2's input, by row stride."""
    from fit_tpu_torch.ops import fused_adaln

    gen = torch.Generator(device=cuda_device).manual_seed(rows + width)
    d = 3072 if width > 8 else 8
    h1 = (torch.randn((2, rows, 3 * d + width), generator=gen, device=cuda_device) * 3).to(dtype)
    cat = torch.zeros((2, rows, d + width), device=cuda_device, dtype=dtype)
    reset_launches()
    fused_adaln.gelu_glue(h1[..., 3 * d :], out=cat[..., d:])
    torch.cuda.synchronize()
    assert launch_counts() == launched(gelu_glue=1)
    want = fused_adaln.gelu_glue(h1[..., 3 * d :], plain=True)
    assert torch.all(cat[..., :d] == 0)
    if dtype == torch.bfloat16:
        assert bf16_ulps(cat[..., d:], want) <= 1
    else:
        torch.testing.assert_close(cat[..., d:], want, rtol=1e-5, atol=1e-5)


def flux_blocks(device, depth=2, single=2):
    """A bf16 FLUX at FLUX.1-schnell's widths (3072, 24 heads of 128, MLP
    12,288), ``depth`` double and ``single`` single blocks, every leaf
    N(0, 0.02) and the QK-norm scales about 2: logits of std ~4, so each
    query weighs a few keys and a row's position or norm moves the output
    (at scales about 1 attention over every key is nearly uniform)."""
    from fit_tpu_torch.models.flux import create_flux
    from fit_tpu_torch.sampling import cast_for_sampling

    model = seeded(create_flux("flux-schnell", depth=depth, depth_single_blocks=single, dtype=torch.bfloat16,
                               device=device), 7)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".scale"):
                p.add_(2.0)
    return cast_for_sampling(model, device)


def flux_inputs(device, n=2, txt=64, h=32, w=48):
    from fit_tpu_torch.diffusion import flow

    gen = torch.Generator(device=device).manual_seed(11)
    z = torch.randn((n, 16, h, w), generator=gen, device=device)
    return dict(img=flow.pack(z), img_ids=flow.img_ids(n, h, w, device),
                txt=torch.randn((n, txt, 4096), generator=gen, device=device), txt_ids=flow.txt_ids(n, txt, device),
                y=torch.randn((n, 768), generator=gen, device=device), timesteps=torch.tensor([0.75, 0.25], device=device))


@pytest.mark.cuda
def test_flux_forward_through_the_kernels_matches_plain(cuda_device):
    """2 double and 2 single blocks at FLUX.1-schnell's widths through K1,
    K5, K5R, K8 and K6G against the same forward through their plain
    versions: 3e-2 relative RMS (the H100 reads 0.0125; a wrong position
    table, text rows at image positions or QK-norm dropped read 0.28-0.65). A double block launches K1 once, K5 and
    K5R, K8 and K6G twice (a stream each); a single block K1, K5, K8 and K6G
    once; the last layer K5 once. The plain forward launches none, and the
    Euler loop over 2 steps stays finite."""
    from fit_tpu_torch.diffusion import flow

    model, x = flux_blocks(cuda_device), flux_inputs(cuda_device)
    with torch.inference_mode():
        reset_launches()
        got = model(**x)
        assert launch_counts() == launched(rope_flash_attention=2 + 2, rope_attention_rotate_k=2 + 2,
                                           adaln_modulate=2 * 2 + 2 + 1,
                                           adaln_residual=2 * 2, qk_norm=2 * 2 + 2, gelu_glue=2 * 2 + 2)
        reset_launches()
        model.plain_kernels = True
        want = model(**x)
        model.plain_kernels = False
        assert launch_counts() == launched()
    assert got.shape == (2, 16 * 24, 64) and got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert rel_rms(got, want) <= 3e-2
    out = flow.denoise(model, x["img"], x["img_ids"], x["txt"], x["txt_ids"], x["y"], [1.0, 0.5, 0.0])
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


# -- Wan2.1: the cross entry, K8W, K5/K5R on an fp32 stream and the video blocks --


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk,lens", [(32760, 512, (512, 512)), (1000, 77, (77, 30)), (333, 512, (512, 1))],
                         ids=["wan", "tq-tail-tk-below-a-tile", "one-key"])
def test_cross_attention_matches_plain_version(cuda_device, tq, tk, lens):
    """The cross entry at Wan2.1-T2V-14B's shapes (40 heads of 128, 32,760
    video rows over 512 text keys), at a query count that is no tile
    multiple over fewer keys than a tile, and with one valid key: q views of
    a (B, Tq, D) projection, k and v views of a (B, Tk, 2D) one, the output
    into a wider buffer. Row by row within 3e-2 of the plain version at the
    output's scale (the bf16 K1 tests' bar, on inputs of std 2: the H100
    reads 0.7-1.0% of the largest value)."""
    from fit_tpu_torch.ops import rope_attention as ra

    gen = torch.Generator(device=cuda_device).manual_seed(tq + tk)
    b, h, d = 2, 40, 128

    def randn(*shape):
        return (torch.randn(shape, generator=gen, device=cuda_device) * 2).to(torch.bfloat16)

    q = randn(b, tq, h * d).view(b, tq, h, d)
    kv = randn(b, tk, 2 * h * d)
    k, v = kv[..., : h * d].view(b, tk, h, d), kv[..., h * d :].view(b, tk, h, d)
    kl = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    wide = torch.zeros((b, tq, 2 * h * d), dtype=torch.bfloat16, device=cuda_device)
    out = wide[..., h * d :].view(b, tq, h, d)
    reset_launches()
    assert ra.cross_attention(q, k, v, kl, d**-0.5, out=out).data_ptr() == out.data_ptr()
    torch.cuda.synchronize()
    assert launch_counts() == launched(cross_attention=1)
    assert torch.all(wide[..., : h * d] == 0)
    for i in range(b):
        want = ra.cross_attention_reference(q[i : i + 1], k[i : i + 1], v[i : i + 1], kl[i : i + 1], d**-0.5)
        err = (out[i : i + 1].float() - want.float()).abs().max().item()
        assert err <= 3e-2 * max(1.0, want.float().abs().max().item())
    with pytest.raises(TypeError):
        ra.cross_attention(q.float(), k.float(), v.float(), kl, d**-0.5)


@pytest.mark.cuda
def test_wan_self_attention_k1_at_the_cells_shape(cuda_device):
    """K1 at the shape Wan2.1-T2V-14B's cell runs it: a [cond | uncond] pair
    of 32,760 video tokens (21 x 30 x 52), 40 heads of 128, q, k and v views
    of one (B, T, 3D) projection with inputs of std 2 (as the cell's
    QK-norm weights of 2 leave them: each query weighs a few keys), Wan's
    (44, 42, 42) RoPE tables, the output into a (B, T, D) buffer. 32,760 is
    255 tiles of 128 and one of 120, of queries and of keys alike: the
    first, a middle and the last, partial query tile of heads 0, 17 and 39
    of both rows against a float64 softmax over all 32,760 rotated keys,
    within 3e-2 of the output's scale (the bf16 K1 tests' bar). One K1 and
    one K pre-pass launch."""
    from fit_tpu_torch.core.pos_embed import rope_ids_nd
    from fit_tpu_torch.models.wan import rope_axes
    from fit_tpu_torch.ops import rope_attention as ra

    b, h, d, grid = 2, 40, 128, (21, 30, 52)
    t = grid[0] * grid[1] * grid[2]
    gen = torch.Generator(device=cuda_device).manual_seed(t)
    qkv = (torch.randn((b, t, 3 * h * d), generator=gen, device=cuda_device) * 2).to(torch.bfloat16)
    q, k, v = qkv.view(b, t, 3, h, d).unbind(2)
    axes = [torch.arange(n, device=cuda_device, dtype=torch.float32) for n in grid]
    ids = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(1, t, 3).expand(b, -1, -1)
    cos, sin = ra.split_rope_tables(rope_ids_nd(ids, rope_axes(d), 10000.0))
    lens = torch.full((b,), t, dtype=torch.int32, device=cuda_device)
    out = torch.empty((b, t, h * d), dtype=torch.bfloat16, device=cuda_device).view(b, t, h, d)
    reset_launches()
    assert ra.rope_flash_attention(q, k, v, cos, sin, lens, d**-0.5, out=out).data_ptr() == out.data_ptr()
    torch.cuda.synchronize()
    assert launch_counts() == launched(rope_flash_attention=1, rope_attention_rotate_k=1)
    assert t % 128 == 120
    tiles = [slice(0, 128), slice(128 * 127, 128 * 128), slice(t - 120, t)]
    heads = [0, 17, 39]
    for i in range(b):
        kr = ra._rope_heads(k[i : i + 1, :, heads], cos[i : i + 1], sin[i : i + 1])[0].transpose(0, 1).double()
        vh = v[i, :, heads].double().transpose(0, 1)  # (heads, T, d)
        for rows in tiles:
            qr = ra._rope_heads(q[i : i + 1, rows][:, :, heads], cos[i : i + 1, rows], sin[i : i + 1, rows])
            scores = qr[0].transpose(0, 1).double() @ kr.transpose(-1, -2) * d**-0.5  # (heads, rows, T)
            want = torch.softmax(scores, dim=-1) @ vh
            got = out[i, rows][:, heads].double().transpose(0, 1)
            err = (got - want).abs().max().item()
            assert err <= 3e-2 * max(1.0, want.abs().max().item()), (i, rows, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_wan_qk_norm_wide_matches_plain_version(cuda_device, dtype):
    """K8W as Wan's blocks call it: a (2, 32,760, 5120) q in place, and the
    k columns of a (2, 512, 2 x 5120) text projection by row stride (v
    untouched); bf16 within 2 ulps (two roundings: the released cast before
    the weight, and the store), fp32 within 1e-5."""
    from fit_tpu_torch.ops import fused_adaln

    gen = torch.Generator(device=cuda_device).manual_seed(5120)

    def randn(*shape):
        return (torch.randn(shape, generator=gen, device=cuda_device) * 3).to(dtype)

    q, kv = randn(2, 32760, 5120), randn(2, 512, 2 * 5120)
    wq, wk = ((2 + 0.2 * torch.randn(5120, generator=gen, device=cuda_device)).to(dtype) for _ in range(2))
    want_q, want_k = fused_adaln.qk_norm_wide_reference(q, wq), fused_adaln.qk_norm_wide_reference(kv[..., :5120], wk)
    v = kv[..., 5120:].clone()
    reset_launches()
    fused_adaln.qk_norm_wide(q, wq)
    fused_adaln.qk_norm_wide(kv[..., :5120], wk)
    torch.cuda.synchronize()
    assert launch_counts() == launched(qk_norm_wide=2)
    assert torch.equal(kv[..., 5120:], v)
    for got, want in ((q, want_q), (kv[..., :5120], want_k)):
        if dtype == torch.bfloat16:
            assert bf16_ulps(got, want) <= 2
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        fused_adaln.qk_norm_wide(q, wq[:128])


@pytest.mark.cuda
@pytest.mark.parametrize("t", [32760, 7])
def test_wan_mixed_adaln_rows_match_plain_version(cuda_device, t):
    """K5 and K5R on Wan's fp32 residual stream with bf16 results: the new
    stream x + gate * y bit for bit the eager fp32 sum, each bf16 row within
    one ulp; norm3 as a column-constant shift and scale (row stride 0)."""
    from fit_tpu_torch.ops import fused_adaln

    gen = torch.Generator(device=cuda_device).manual_seed(t)
    x = torch.randn((2, t, 5120), generator=gen, device=cuda_device) * 3 + 1
    y = torch.randn((2, t, 5120), generator=gen, device=cuda_device).to(torch.bfloat16)
    cond = torch.randn((2, 9, 5120), generator=gen, device=cuda_device) * 0.3
    bias, scale = (torch.randn(5120, generator=gen, device=cuda_device) * 0.1 for _ in range(2))
    reset_launches()
    h = fused_adaln.adaln_modulate(x, cond[:, 0], cond[:, 1], out_dtype=torch.bfloat16)
    x_new, h2 = fused_adaln.adaln_residual(x, y, cond[:, 2], cond[:, 3], cond[:, 4], out_dtype=torch.bfloat16)
    h3 = fused_adaln.adaln_modulate(x, bias.expand(2, -1), scale.expand(2, -1), out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert launch_counts() == launched(adaln_modulate=2, adaln_residual=1)
    assert h.dtype == h2.dtype == torch.bfloat16 and x_new.dtype == torch.float32
    want_x, want_h2 = fused_adaln.adaln_residual(x, y, cond[:, 2], cond[:, 3], cond[:, 4], out_dtype=torch.bfloat16,
                                                 plain=True)
    assert torch.equal(x_new, want_x)
    for got, want in ((h, fused_adaln.adaln_reference(x, cond[:, 0], cond[:, 1], out_dtype=torch.bfloat16)),
                      (h2, want_h2),
                      (h3, fused_adaln.adaln_reference(x, bias.expand(2, -1), scale.expand(2, -1),
                                                       out_dtype=torch.bfloat16))):
        assert bf16_ulps(got, want) <= 1
    with pytest.raises(TypeError):
        fused_adaln.adaln_modulate(x.to(torch.bfloat16), cond[:, 0], cond[:, 1], out_dtype=torch.float32)


def wan_blocks(device, depth=2):
    """A bf16 Wan at Wan2.1-T2V-14B's widths (5120, 40 heads of 128, FFN
    13,824), ``depth`` blocks, every leaf N(0, 0.02), the QK-RMSNorm weights
    about 2 and norm3's about 1: each query weighs a few keys, so a
    position or a norm moves the output."""
    from fit_tpu_torch.models.wan import create_wan
    from fit_tpu_torch.sampling import cast_for_sampling

    model = seeded(create_wan("wan2.1-t2v-14b", num_layers=depth, dtype=torch.bfloat16, device=device), 13)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("norm_q.weight", "norm_k.weight")):
                p.add_(2.0)
            elif name.endswith("norm3.weight"):
                p.add_(1.0)
    return cast_for_sampling(model, device)


@pytest.mark.cuda
def test_wan_forward_through_the_kernels_matches_plain(cuda_device):
    """2 blocks at Wan2.1-T2V-14B's widths over a (16, 5, 16, 24) latent
    (480 tokens) and 512 text rows, a [cond | uncond] pair, through K1, the
    cross entry, K5, K5R, K8W and K6G against the same forward through
    their plain versions: 3e-2 relative RMS. A block launches K1 (and its K
    pre-pass) and the cross entry once, K5 once, K5R twice, K8W four times
    and K6G once; the head K5 once. The plain forward launches none, and
    the guided Euler loop over 2 steps stays finite."""
    from fit_tpu_torch.diffusion import flow

    model = wan_blocks(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    z = torch.randn((1, 16, 5, 16, 24), generator=gen, device=cuda_device)
    ctx = torch.randn((2, 512, 4096), generator=gen, device=cuda_device)
    ctx[1, 100:] = 0  # the negative prompt's rows past its length
    t = torch.tensor([900.0, 900.0], device=cuda_device)
    with torch.inference_mode():
        reset_launches()
        got = model(torch.cat((z, z)), t, ctx)
        assert launch_counts() == launched(rope_flash_attention=2, rope_attention_rotate_k=2, cross_attention=2,
                                           adaln_modulate=2 + 1, adaln_residual=2 * 2, qk_norm_wide=2 * 4,
                                           gelu_glue=2)
        reset_launches()
        model.plain_kernels = True
        want = model(torch.cat((z, z)), t, ctx)
        model.plain_kernels = False
        assert launch_counts() == launched()
    assert got.shape == (2, 16, 5, 16, 24) and got.dtype == torch.float32 and torch.isfinite(got).all()
    assert rel_rms(got, want) <= 3e-2
    out = flow.denoise_guided(model, z, ctx[:1], ctx[1:], flow.shifted_schedule(2, 5.0), 5.0)
    assert out.shape == z.shape and torch.isfinite(out).all()
