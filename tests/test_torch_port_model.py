"""fit_tpu_torch.models against fit_tpu.models on the same weights.

The converter carries randomised flax params (the reference init is the
zero function) into the port's state_dict; the port's FiT (plain attention
on the CPU) is then held against flax ``FiT.apply`` with the XLA attention
and with the fused Pallas kernels (interpret mode off the TPU). All fp32,
valid tokens only. Tolerance 3e-5: fp32 with another summation order, the
bar of tests/test_torch_parity.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fit_tpu.core.pos_embed import rope_freqs_2d
from fit_tpu.models import FiT as JaxFiT
from fit_tpu_torch.models.fit import FiT, FiT_models, create_fit
from fit_tpu_torch.models.from_jax import torch_state_dict_from_flax

B, T, P, C = 2, 64, 2, 4
HID, HEADS, DEPTH = 96, 6, 2
HEAD_DIM = HID // HEADS
NUM_CLASSES = 10
ATOL = 3e-5


def jax_model(backend="xla", dropout=0.0, scan=False):
    return JaxFiT(
        patch_size=P, in_channels=C, hidden_size=HID, depth=DEPTH, num_heads=HEADS,
        num_classes=NUM_CLASSES, class_dropout_prob=dropout, attn_backend=backend,
        scan_blocks=scan,
    )


def torch_model(dropout=0.0):
    return FiT(
        patch_size=P, in_channels=C, hidden_size=HID, depth=DEPTH, num_heads=HEADS,
        num_classes=NUM_CLASSES, class_dropout_prob=dropout,
    )


def random_params(model, tokens, t, y, pos, mask, seed):
    params = model.init(
        {"params": jax.random.PRNGKey(0), "label_dropout": jax.random.PRNGKey(1)},
        *(jnp.asarray(a) for a in (tokens, t, y, pos, mask)), train=True,
    )
    leaves, td = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree.unflatten(
        td, [0.05 * jax.random.normal(k, l.shape, l.dtype) for k, l in zip(keys, leaves)]
    )


def inputs(valid, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.normal(size=(B, T, P * P * C)).astype(np.float32)
    pos = np.zeros((B, T, HEAD_DIM), np.float32)
    mask = np.zeros((B, T), bool)
    for i, n in enumerate(valid):
        pos[i, :n] = rope_freqs_2d(HEAD_DIM, 8, 8)[:n]
        mask[i, :n] = True
    t = rng.integers(0, 1000, size=(B,)).astype(np.int32)
    y = rng.integers(0, NUM_CLASSES, size=(B,)).astype(np.int32)
    return tokens, t, y, pos, mask


def port(params, dropout=0.0):
    model = torch_model(dropout)
    p_np = jax.tree.map(np.asarray, params)
    model.load_state_dict(torch_state_dict_from_flax(p_np, DEPTH))
    return model.eval()


def close_on_valid(got, want, valid):
    for i, n in enumerate(valid):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=ATOL, rtol=0)


@pytest.mark.parametrize("backend", ["xla", "fused"])
@pytest.mark.parametrize("valid", [(64, 64), (48, 21)], ids=["full", "padded"])
def test_token_forward_matches_flax(backend, valid):
    tokens, t, y, pos, mask = inputs(valid)
    jm = jax_model(backend)
    params = random_params(jm, tokens, t, y, pos, mask, seed=5)
    want = np.asarray(jm.apply(params, *(jnp.asarray(a) for a in (tokens, t, y, pos, mask)), train=True))
    with torch.no_grad():
        got = port(params)(*(torch.from_numpy(a) for a in (tokens, t, y, pos, mask)), train=True)
    assert got.shape == want.shape == (B, T, P * P * C)
    close_on_valid(got.numpy(), want, valid)


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_forward_with_cfg_on_canvas_matches_flax(backend):
    """Eval path: canvas in, guided eps out, null class row in the table."""
    valid = (40, 40)  # a 10x16 latent (5x8 patches) packed on a 16x16 canvas
    tokens, t, y, pos, mask = inputs(valid, seed=1)
    jm = jax_model(backend, dropout=0.1)
    params = random_params(jm, tokens, t, y, pos, mask, seed=6)
    canvas = np.random.default_rng(2).normal(size=(B, C, 16, 16)).astype(np.float32)
    y[1] = NUM_CLASSES  # the null-class half
    want = np.asarray(jm.apply(
        params, *(jnp.asarray(a) for a in (canvas, t, y, pos, mask)), 1.5,
        method=JaxFiT.forward_with_cfg,
    ))
    with torch.no_grad():
        got = port(params, dropout=0.1).forward_with_cfg(
            *(torch.from_numpy(a) for a in (canvas, t, y, pos, mask)), 1.5
        ).numpy()
    assert got.shape == want.shape == (B, C, 16, 16)
    # compare the valid tokens: the first 40 patches of the 16x16 canvas
    patches = lambda a: a.reshape(B, C, 8, 2, 8, 2).transpose(0, 2, 4, 3, 5, 1).reshape(B, 64, -1)
    close_on_valid(patches(got), patches(want), valid)


def test_scan_stacked_params_convert():
    valid = (64, 33)
    tokens, t, y, pos, mask = inputs(valid, seed=3)
    jm = jax_model("xla", scan=True)
    params = random_params(jm, tokens, t, y, pos, mask, seed=7)
    assert "blocks" in params["params"]
    want = np.asarray(jm.apply(params, *(jnp.asarray(a) for a in (tokens, t, y, pos, mask)), train=True))
    with torch.no_grad():
        got = port(params)(*(torch.from_numpy(a) for a in (tokens, t, y, pos, mask)), train=True)
    close_on_valid(got.numpy(), want, valid)


def test_converter_layout():
    tokens, t, y, pos, mask = inputs((64, 64))
    params = random_params(jax_model(), tokens, t, y, pos, mask, seed=8)
    sd = torch_state_dict_from_flax(jax.tree.map(np.asarray, params), DEPTH)
    qkv = np.asarray(params["params"]["blocks_1"]["attn"]["qkv"]["kernel"])  # (D, 3, C)
    assert qkv.shape == (HID, 3, HID)
    np.testing.assert_array_equal(sd["blocks.1.attn.qkv.weight"].numpy(), qkv.reshape(HID, -1).T)
    np.testing.assert_array_equal(
        sd["blocks.1.attn.qkv.bias"].numpy(),
        np.asarray(params["params"]["blocks_1"]["attn"]["qkv"]["bias"]).reshape(-1),
    )
    assert set(sd) == set(torch_model().state_dict())


def test_reference_init_and_registry():
    assert len(FiT_models) == 12
    m = FiT_models["FiT-S/4"](num_classes=NUM_CLASSES, device="cpu")
    assert (m.depth, m.hidden_size, m.num_heads, m.patch_size) == (12, 384, 6, 4)
    assert m.blocks[0].ffn.fc1_g.out_features == int(384 * 4 * 2 / 3)
    assert m.y_embedder.table.num_embeddings == NUM_CLASSES + 1
    # adaLN-Zero and the zero final layer: the untrained model predicts eps = 0
    tokens, t, y, pos, mask = inputs((64, 40))
    small = torch_model(dropout=0.1)
    with torch.no_grad():
        out = small(
            *(torch.from_numpy(a) for a in (tokens, t, y, pos, mask)), train=True,
            generator=torch.Generator().manual_seed(0),
        )
    assert out.abs().max() == 0
    # xavier-uniform with the flat (D, 3D) fans: std sqrt(2 / (D + 3D))
    assert abs(small.blocks[0].attn.qkv.weight.std().item() - (2 / (4 * HID)) ** 0.5) < 0.01
    xl = create_fit("FiT-XL/2", device="meta")
    assert (xl.depth, xl.head_dim, len(xl.blocks)) == (28, 72, 28)


def test_label_dropout_and_bf16_compute():
    tokens, t, y, pos, mask = inputs((64, 50))
    m = torch_model(dropout=0.1)
    drop = torch.tensor([1, 0])
    emb = m.y_embedder(torch.from_numpy(y).long(), False, torch.float32, force_drop_ids=drop)
    torch.testing.assert_close(emb[0], m.y_embedder.table.weight[NUM_CLASSES])
    m.dtype = torch.bfloat16
    with torch.no_grad():
        out = m(
            *(torch.from_numpy(a) for a in (tokens, t, y, pos, mask)), train=True,
            generator=torch.Generator().manual_seed(0),
        )
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
