"""Seeded weights, made on the device in a few large calls.

Every weight of a cell comes from one ``torch.Generator`` on the device,
seeded from the run's ``--seed``: one normal draw fills a flat fp32 buffer
for all leaves, one multiply and one add give each leaf its scale and
mean, and the leaves are views of that buffer. The same seed gives the
same weights, so the reference remakes them after the window instead of
reading the program's copy.
"""

from __future__ import annotations

import zlib
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

Spec = List[Tuple[str, Tuple[int, ...]]]


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's seed; any whole
    number works, negative or past 64 bits."""
    words = [int(w) for w in np.frombuffer(int(seed).to_bytes(16, "little", signed=True), np.uint32)]
    state = np.random.SeedSequence(words + [zlib.crc32(tag.encode())]).generate_state(2, np.uint32)
    return int(state[0]) | (int(state[1] & 0x7FFFFFFF) << 32)


def make(spec: Spec, init: Callable[[str, Tuple[int, ...]], Tuple[float, float]], seed: int, device) -> Dict[str, "object"]:
    """{name: fp32 tensor} for ``spec`` (name, shape) in its order, each
    leaf drawn as ``mean + std * N(0, 1)`` with ``(std, mean) =
    init(name, shape)``."""
    import torch

    sizes = [int(np.prod(shape)) for _, shape in spec]
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    stats = [init(name, shape) for name, shape in spec]
    counts = torch.tensor(sizes, device=device)
    std = torch.tensor([s for s, _ in stats], device=device, dtype=torch.float32)
    mean = torch.tensor([m for _, m in stats], device=device, dtype=torch.float32)
    flat.mul_(std.repeat_interleave(counts)).add_(mean.repeat_interleave(counts))
    return {name: part.view(shape) for (name, shape), part in zip(spec, flat.split(sizes))}


def load_into(module, weights: Dict[str, "object"], prefix: str = "") -> None:
    """Copy ``weights`` into ``module``'s parameters of the same names
    (``prefix`` + name); every parameter named must exist and match."""
    import torch

    params = dict(module.named_parameters())
    names = [prefix + n for n in weights]
    missing = [n for n in names if n not in params]
    if missing:
        raise KeyError(f"the program has no parameters {missing[:5]}")
    with torch.no_grad():
        dst = [params[prefix + n].data for n in weights]
        torch._foreach_copy_(dst, [w.to(d.dtype) for w, d in zip(weights.values(), dst)])


def fit_spec(m: dict) -> Spec:
    """The FiT denoiser's leaves, ``nn.Linear`` layout (out, in)."""
    d, depth = m["hidden_size"], m["depth"]
    dh = int(d * m["mlp_ratio"] * 2 / 3)
    pdim = m["patch_size"] ** 2 * m["in_channels"]
    out = m["patch_size"] ** 2 * m["in_channels"] * (2 if m.get("learn_sigma") else 1)
    spec: Spec = [
        ("x_embedder.weight", (d, pdim)), ("x_embedder.bias", (d,)),
        ("t_embedder.fc1.weight", (d, 256)), ("t_embedder.fc1.bias", (d,)),
        ("t_embedder.fc2.weight", (d, d)), ("t_embedder.fc2.bias", (d,)),
        ("y_embedder.table.weight", (m["num_classes"] + 1, d)),
    ]
    for i in range(depth):
        b = f"blocks.{i}."
        spec += [
            (b + "adaLN.weight", (6 * d, d)), (b + "adaLN.bias", (6 * d,)),
            (b + "attn.qkv.weight", (3 * d, d)), (b + "attn.qkv.bias", (3 * d,)),
            (b + "attn.proj.weight", (d, d)), (b + "attn.proj.bias", (d,)),
            (b + "ffn.fc1_g.weight", (dh, d)), (b + "ffn.fc1_g.bias", (dh,)),
            (b + "ffn.fc1_x.weight", (dh, d)), (b + "ffn.fc1_x.bias", (dh,)),
            (b + "ffn.fc2.weight", (d, dh)), (b + "ffn.fc2.bias", (d,)),
        ]
    spec += [
        ("final.adaLN.weight", (2 * d, d)), ("final.adaLN.bias", (2 * d,)),
        ("final.linear.weight", (out, d)), ("final.linear.bias", (out,)),
    ]
    return spec


def fit_init(name: str, shape: Sequence[int]) -> Tuple[float, float]:
    """Every leaf random, none zero (so every block and the conditioning
    reach the output): fan-in scaled weights, adaLN at half that (gates
    and scales of about 0.3), unit-scale label embeddings, small biases."""
    if name.endswith("bias"):
        return 0.02, 0.0
    if name == "y_embedder.table.weight":
        return 1.0, 0.0
    scale = 0.5 if "adaLN" in name else 1.0
    return scale / float(np.sqrt(shape[1])), 0.0


def vae_decoder_spec(v: dict) -> Spec:
    """The SD-VAE decoder's leaves (``decoder.`` names of the program's
    ``AutoencoderKL``): conv weights (out, in, k, k)."""
    rev = list(reversed(v["block_out_channels"]))
    lat = v["latent_channels"]
    spec: Spec = []

    def conv(name, cin, cout, k):
        spec.extend([(name + ".weight", (cout, cin, k, k)), (name + ".bias", (cout,))])

    def norm(name, c):
        spec.extend([(name + ".weight", (c,)), (name + ".bias", (c,))])

    def resnet(name, cin, cout):
        norm(name + ".norm1", cin)
        conv(name + ".conv1", cin, cout, 3)
        norm(name + ".norm2", cout)
        conv(name + ".conv2", cout, cout, 3)
        if cin != cout:
            conv(name + ".shortcut", cin, cout, 1)

    conv("decoder.post_quant_conv", lat, lat, 1)
    conv("decoder.conv_in", lat, rev[0], 3)
    resnet("decoder.mid_block_1", rev[0], rev[0])
    norm("decoder.mid_attn.norm", rev[0])
    for p in ("q", "k", "v", "proj_out"):
        spec.extend([(f"decoder.mid_attn.{p}.weight", (rev[0], rev[0])), (f"decoder.mid_attn.{p}.bias", (rev[0],))])
    resnet("decoder.mid_block_2", rev[0], rev[0])
    prev = rev[0]
    for i, ch in enumerate(rev):
        for j in range(v["decoder_layers_per_block"]):
            resnet(f"decoder.up_{i}_block_{j}", prev, ch)
            prev = ch
        if i < len(rev) - 1:
            conv(f"decoder.up_{i}_upsample.conv", ch, ch, 3)
    norm("decoder.norm_out", rev[-1])
    conv("decoder.conv_out", rev[-1], v["out_channels"], 3)
    return spec


def vae_init(name: str, shape: Sequence[int]) -> Tuple[float, float]:
    """GroupNorm scales about 1; fan-in scaled convolutions and attention
    projections; the output convolution at half scale, so that few pixels
    clip at [-1, 1]."""
    if "norm" in name and len(shape) == 1:
        return (0.1, 1.0) if name.endswith("weight") else (0.02, 0.0)
    if name.endswith("bias"):
        return 0.02, 0.0
    fan_in = int(np.prod(shape[1:]))
    scale = 0.5 if name.startswith("decoder.conv_out") else 1.0
    return scale / float(np.sqrt(fan_in)), 0.0
