"""fit_tpu_torch's SD VAE against fit_tpu's flax AutoencoderKL, on the CPU.

Small config (block_out_channels (8, 16), as tests/test_vae.py), fp32 on
both sides, the same weights through each converter: a fake diffusers
state dict of each attention style (random everywhere, norms and biases
included, so a mis-mapped leaf shows) through ``fit_tpu.vae.convert`` and
``fit_tpu_torch.vae.convert``, and a flax init through
``fit_tpu_torch.models.from_jax``. ``encode_moments``, ``encode_mode``,
``encode`` (the noise fit_tpu draws, injected) and ``decode`` agree within
1e-4 absolute and relative: convolutions and GroupNorm summed in another
order. The bf16 module is held to 5e-2 relative RMS of the fp32 one (the
bar of the guided bf16 forwards); the uint8 images of a decode to one step
of fit_tpu's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fit_tpu.vae import AutoencoderKL as JaxVAE
from fit_tpu.vae import DiagonalGaussian as JaxDiagonalGaussian
from fit_tpu.vae import convert_torch_state_dict
from fit_tpu_torch.models.from_jax import torch_vae_state_dict_from_flax
from fit_tpu_torch.vae import (
    SD_VAE_SCALING,
    AutoencoderKL,
    DiagonalGaussian,
    convert_state_dict,
    load_autoencoder,
    load_checkpoint,
    resolve_checkpoint,
    to_uint8,
)
from fit_tpu_torch.vae.convert import infer_config, to_diffusers_state_dict

BLOCKS = (8, 16)
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_REL_RMS = 5e-2


def fake_diffusers_sd(attn_style="new", block_out=BLOCKS, latent=4, seed=5):
    """A random diffusers AutoencoderKL state dict (numpy), every leaf random."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, o, i, k=3):
        sd[f"{name}.weight"] = rng.normal(size=(o, i, k, k)).astype(np.float32) * 0.05
        sd[f"{name}.bias"] = rng.normal(size=(o,)).astype(np.float32) * 0.02

    def norm(name, c):
        sd[f"{name}.weight"] = (1.0 + 0.2 * rng.normal(size=(c,))).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(size=(c,)).astype(np.float32) * 0.1

    def lin(name, c):
        sd[f"{name}.weight"] = rng.normal(size=(c, c)).astype(np.float32) * 0.05
        sd[f"{name}.bias"] = rng.normal(size=(c,)).astype(np.float32) * 0.02

    def resnet(prefix, cin, cout):
        norm(f"{prefix}.norm1", cin)
        conv(f"{prefix}.conv1", cout, cin)
        norm(f"{prefix}.norm2", cout)
        conv(f"{prefix}.conv2", cout, cout)
        if cin != cout:
            conv(f"{prefix}.conv_shortcut", cout, cin, k=1)

    def attn(prefix, c):
        if attn_style == "new":
            norm(f"{prefix}.group_norm", c)
            for n in ("to_q", "to_k", "to_v", "to_out.0"):
                lin(f"{prefix}.{n}", c)
        else:
            norm(f"{prefix}.norm", c)
            for n in ("q", "k", "v", "proj_out"):
                conv(f"{prefix}.{n}", c, c, k=1)

    conv("encoder.conv_in", block_out[0], 3)
    ch = block_out[0]
    for i, out in enumerate(block_out):
        for j in range(2):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", ch, out)
            ch = out
        if i < len(block_out) - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", out, out)
    resnet("encoder.mid_block.resnets.0", ch, ch)
    attn("encoder.mid_block.attentions.0", ch)
    resnet("encoder.mid_block.resnets.1", ch, ch)
    norm("encoder.conv_norm_out", ch)
    conv("encoder.conv_out", 2 * latent, ch)
    conv("quant_conv", 2 * latent, 2 * latent, k=1)
    conv("post_quant_conv", latent, latent, k=1)
    rev = list(reversed(block_out))
    conv("decoder.conv_in", rev[0], latent)
    resnet("decoder.mid_block.resnets.0", rev[0], rev[0])
    attn("decoder.mid_block.attentions.0", rev[0])
    resnet("decoder.mid_block.resnets.1", rev[0], rev[0])
    ch = rev[0]
    for i, out in enumerate(rev):
        for j in range(3):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", ch, out)
            ch = out
        if i < len(rev) - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", out, out)
    norm("decoder.conv_norm_out", ch)
    conv("decoder.conv_out", 3, ch)
    return sd


SOURCES = ["diffusers-new", "diffusers-old", "flax-init"]


@pytest.fixture(scope="module", params=SOURCES)
def pair(request):
    """(flax params, the port's fp32 module) on the same weights."""
    if request.param == "flax-init":
        params = JaxVAE(block_out_channels=BLOCKS).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)), jax.random.PRNGKey(1))
        state = torch_vae_state_dict_from_flax(jax.tree.map(np.asarray, params))
    else:
        sd = fake_diffusers_sd(request.param.split("-")[1])
        params = jax.tree.map(jnp.asarray, convert_torch_state_dict(sd, block_out_channels=BLOCKS))
        state = convert_state_dict(sd, block_out_channels=BLOCKS)
    vae = AutoencoderKL(BLOCKS, device="cpu")
    vae.load_state_dict(state)
    return params, vae


def images(seed=7, shape=(2, 3, 32, 48)):
    return np.random.default_rng(seed).uniform(-1, 1, size=shape).astype(np.float32)


def nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


@pytest.mark.parametrize("method", ["encode_moments", "encode_mode", "encode", "decode"])
def test_vae_matches_flax(pair, method):
    params, vae = pair
    jvae = JaxVAE(block_out_channels=BLOCKS)
    x = images()
    with torch.no_grad():
        if method == "encode_moments":
            want = nchw(jvae.apply(params, jnp.asarray(x), method=JaxVAE.encode_moments))
            got = vae.encode_moments(torch.from_numpy(x))
        elif method == "encode_mode":
            want = jvae.apply(params, jnp.asarray(x), method=JaxVAE.encode_mode)
            got = vae.encode_mode(torch.from_numpy(x))
        elif method == "encode":
            rng = jax.random.PRNGKey(3)
            want = jvae.apply(params, jnp.asarray(x), rng, method=JaxVAE.encode)
            mean_shape = (x.shape[0], x.shape[2] // 2, x.shape[3] // 2, 4)  # NHWC, one downsample
            noise = nchw(jax.random.normal(rng, mean_shape, jnp.float32))
            got = vae.encode(torch.from_numpy(x), noise=torch.from_numpy(noise))
        else:
            z = np.random.default_rng(1).normal(size=(2, 4, 16, 24)).astype(np.float32) * SD_VAE_SCALING
            want = jvae.apply(params, jnp.asarray(z), method=JaxVAE.decode)
            got = vae.decode(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((got - want) ** 2).mean() / (want**2).mean()))


def test_bf16_vae_against_fp32(pair):
    """The bf16 module (fp32 GroupNorm, SiLU and attention scores, as
    fit_tpu's) within 5e-2 relative RMS of the fp32 one."""
    _, vae = pair
    vb = AutoencoderKL(BLOCKS, dtype=torch.bfloat16, device="cpu")
    vb.load_state_dict(vae.state_dict())
    x = torch.from_numpy(images(9))
    z = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 4, 16, 24)).astype(np.float32) * SD_VAE_SCALING)
    with torch.no_grad():
        dec, enc = vb.decode(z), vb.encode_mode(x)
        assert dec.dtype == enc.dtype == torch.bfloat16
        assert rel_rms(dec.float(), vae.decode(z)) <= BF16_REL_RMS
        assert rel_rms(enc.float(), vae.encode_mode(x)) <= BF16_REL_RMS


def test_decode_to_uint8_within_one_step_of_flax(pair):
    """The images as written (clip, x255, truncate) within one uint8 step
    of fit_tpu's, element by element."""
    params, vae = pair
    z = np.random.default_rng(4).normal(size=(2, 4, 16, 16)).astype(np.float32) * SD_VAE_SCALING
    want = np.asarray(JaxVAE(block_out_channels=BLOCKS).apply(params, jnp.asarray(z), method=JaxVAE.decode))
    want = (np.clip((want + 1) / 2, 0, 1).transpose(0, 2, 3, 1) * 255).astype(np.uint8)
    with torch.no_grad():
        got = to_uint8(vae.decode(torch.from_numpy(z)))
    assert got.shape == want.shape == (2, 32, 32, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_diagonal_gaussian_matches_flax():
    rng = np.random.default_rng(1)
    moments = rng.normal(size=(2, 8, 4, 4)).astype(np.float32) * 20  # logvar beyond [-30, 20] clips
    noise = rng.normal(size=(2, 4, 4, 4)).astype(np.float32)
    dist, jdist = DiagonalGaussian(torch.from_numpy(moments)), JaxDiagonalGaussian(jnp.asarray(nchw_to_nhwc(moments)))
    np.testing.assert_allclose(dist.logvar.numpy(), nchw(jdist.logvar), rtol=1e-6)
    np.testing.assert_allclose(dist.std.numpy(), nchw(jdist.std), rtol=1e-6)
    assert torch.equal(dist.mode(), torch.from_numpy(moments[:, :4]))
    np.testing.assert_allclose(dist.sample(noise=torch.from_numpy(noise)).numpy(),
                               moments[:, :4] + nchw(jdist.std) * noise, rtol=1e-6)
    a, b = (dist.sample(torch.Generator().manual_seed(0)) for _ in range(2))
    assert torch.equal(a, b) and not torch.equal(a, dist.sample(torch.Generator().manual_seed(1)))


def nchw_to_nhwc(x):
    return np.transpose(x, (0, 2, 3, 1))


@pytest.mark.parametrize("fault", ["missing", "unknown", "misnamed"])
def test_converter_names_a_missing_or_unknown_key(fault):
    sd = fake_diffusers_sd()
    if fault == "missing":
        del sd["decoder.up_blocks.1.resnets.2.norm2.bias"]
        key = "decoder.up_blocks.1.resnets.2.norm2.bias"
    elif fault == "unknown":
        sd["encoder.mid_block.attentions.0.extra.weight"] = np.zeros(1, np.float32)
        key = "encoder.mid_block.attentions.0.extra.weight"
    else:
        sd["encoder.conv_inn.weight"] = sd.pop("encoder.conv_in.weight")
        key = "encoder.conv_in.weight"
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        convert_state_dict(sd, block_out_channels=BLOCKS)


@pytest.mark.parametrize("ext", [".bin", ".safetensors"])
def test_load_autoencoder_from_a_file_or_directory(tmp_path, ext):
    """A diffusers checkpoint file, or a directory with sd-vae-ft-mse,
    loads at its own widths (inferred) and decodes as convert_state_dict's
    weights do."""
    sd = fake_diffusers_sd("old")
    path = tmp_path / f"sd-vae-ft-mse{ext}"
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    if ext == ".bin":
        torch.save(tensors, path)
    else:
        from safetensors.torch import save_file

        save_file(tensors, str(path))
    assert resolve_checkpoint(str(tmp_path), "mse") == str(path)
    with pytest.raises(FileNotFoundError, match="sd-vae-ft-ema"):
        resolve_checkpoint(str(tmp_path), "ema")
    assert infer_config(load_checkpoint(str(path))) == {"block_out_channels": BLOCKS, "latent_channels": 4}
    vae = load_autoencoder(str(tmp_path), "mse", device="cpu")
    ref = AutoencoderKL(BLOCKS, device="cpu")
    ref.load_state_dict(convert_state_dict(sd, block_out_channels=BLOCKS))
    z = torch.randn(1, 4, 8, 8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(vae.decode(z), ref.decode(z))


def test_vae_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("there is a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AutoencoderKL(BLOCKS)


def test_full_width_state_dict_matches_flax_init_tree():
    """The published SD-VAE's parameter names and shapes: the port's module
    is fit_tpu's tree, leaf for leaf (built on the meta device)."""
    shapes = jax.eval_shape(lambda: JaxVAE().init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)),
                                                   jax.random.PRNGKey(1)))
    leaves = torch_vae_state_dict_from_flax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    ours = AutoencoderKL(device="meta").state_dict()
    assert {k: tuple(v.shape) for k, v in ours.items()} == {k: tuple(v.shape) for k, v in leaves.items()}
    assert sum(v.numel() for v in ours.values()) == 83_653_863


@pytest.mark.parametrize("style", ["new", "old"])
def test_to_diffusers_state_dict_round_trips(style):
    sd = fake_diffusers_sd(style)
    state = convert_state_dict(sd, block_out_channels=BLOCKS)
    back = to_diffusers_state_dict(state, BLOCKS, attn_style=style)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
