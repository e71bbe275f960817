"""fit_tpu_torch.models.convert against fit_tpu's converter.

A synthetic reference (PyTorch Lightning) FiT state dict at the contract
size (hidden 96, 6 heads, depth 2, T 64), with its prefixes, goes through
the port's converter into the port's FiT and through fit_tpu's converter
into fit_tpu's FiT; the two fp32 forwards agree within atol 3e-5, the
contract's bar for an fp32 forward on the CPU. EMA weights are found in
the optimizer state, in a ``-EMA`` sidecar and in a ``-EMA`` file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fit_tpu.core.pos_embed import rope_freqs_2d
from fit_tpu.models import FiT as JaxFiT
from fit_tpu.models.convert import convert_torch_fit_state_dict as j_convert
from fit_tpu_torch.models.convert import (
    convert_torch_fit_state_dict,
    load_torch_fit_checkpoint,
    resolve_reference_state_dict,
)
from fit_tpu_torch.models.fit import FiT

HID, HEADS, DEPTH, T, P, C = 96, 6, 2, 64, 2, 4
NUM_CLASSES = 10


def reference_state_dict(seed, prefix="model._orig_mod."):
    """Random weights in the reference's module layout and key order, with
    the CFG null-class row (class dropout 0.1)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, out_f, in_f):
        sd[f"{name}.weight"] = torch.tensor(rng.normal(size=(out_f, in_f)).astype(np.float32) * 0.05)
        sd[f"{name}.bias"] = torch.tensor(rng.normal(size=(out_f,)).astype(np.float32) * 0.05)

    hidden_ffn = int(HID * 4 * 2 / 3)
    put("x_embedder", HID, P * P * C)
    put("t_embedder.mlp.0", HID, 256)
    put("t_embedder.mlp.2", HID, HID)
    sd["y_embedder.embedding_table.weight"] = torch.tensor(
        rng.normal(size=(NUM_CLASSES + 1, HID)).astype(np.float32) * 0.05
    )
    for i in range(DEPTH):
        put(f"blocks.{i}.attn.qkv", 3 * HID, HID)
        put(f"blocks.{i}.attn.proj", HID, HID)
        put(f"blocks.{i}.ffn.fc1_g", hidden_ffn, HID)
        put(f"blocks.{i}.ffn.fc1_x", hidden_ffn, HID)
        put(f"blocks.{i}.ffn.fc2", HID, hidden_ffn)
        put(f"blocks.{i}.adaLN_modulation.1", 6 * HID, HID)
    put("final_layer.adaLN_modulation.1", 2 * HID, HID)
    put("final_layer.linear", P * P * C, HID)
    return {f"{prefix}{k}": v for k, v in sd.items()}


def port_model():
    return FiT(patch_size=P, in_channels=C, hidden_size=HID, depth=DEPTH, num_heads=HEADS,
               num_classes=NUM_CLASSES, device="cpu")


def forward_pair(sd_np):
    """The fp32 forward of both packages on one batch, each loaded through
    its own converter from the same reference state dict."""
    jm = JaxFiT(patch_size=P, in_channels=C, hidden_size=HID, depth=DEPTH, num_heads=HEADS,
                num_classes=NUM_CLASSES, attn_backend="xla")
    params = jax.tree.map(jnp.asarray, j_convert(sd_np, depth=DEPTH))
    tm = port_model()
    tm.load_state_dict(convert_torch_fit_state_dict(sd_np, tm.state_dict()))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, C, 16, 16)).astype(np.float32)
    pos = np.broadcast_to(rope_freqs_2d(HID // HEADS, 8, 8), (2, T, HID // HEADS)).copy()
    mask = np.ones((2, T), bool)
    mask[1, 40:] = False
    t, y = np.array([10, 900]), np.array([3, NUM_CLASSES])
    want = jm.apply(params, *map(jnp.asarray, (x, t, y, pos, mask)), train=False)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (x, t, y, pos, mask)), train=False)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("prefix", ["model._orig_mod.", "model.", "_orig_mod.", ""])
def test_converted_forward_matches_jax(prefix):
    sd = reference_state_dict(3, prefix)
    got, want = forward_pair({k: v.numpy() for k, v in sd.items()})
    assert got.shape == want.shape == (2, C, 16, 16)
    # latent rows 0-9 hold tokens 0-39, valid in both rows of the batch
    np.testing.assert_allclose(got[:, :, :10], want[:, :, :10], atol=3e-5, rtol=0)


def test_converter_takes_tensors_and_arrays_alike():
    sd = reference_state_dict(4)
    a = convert_torch_fit_state_dict(sd)
    b = convert_torch_fit_state_dict({k: v.numpy() for k, v in sd.items()})
    assert list(a) == list(b) and "blocks.1.adaLN.weight" in a and "final.linear.bias" in a
    for k in a:
        assert a[k].dtype == torch.float32
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def _ema_parts(seed=9):
    sd = reference_state_dict(seed, "model.")
    ema = [v * 0.5 for v in sd.values()]  # distinct from the raw weights
    opt_state = {"opt": {}, "ema": ema, "current_step": 5, "decay": 0.9999, "every_n_steps": 1}
    return sd, ema, opt_state


def _assert_weights(got, sd, values):
    want = convert_torch_fit_state_dict(dict(zip(sd, values)))
    assert list(got) == list(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_ema_from_lightning_optimizer_state(tmp_path):
    sd, ema, opt_state = _ema_parts()
    path = tmp_path / "epoch=3.ckpt"
    torch.save({"state_dict": sd, "optimizer_states": [opt_state], "hyper_parameters": {"lr": 1e-4}}, path)
    expected = port_model().state_dict()
    _assert_weights(load_torch_fit_checkpoint(str(path), expected), sd, ema)
    _assert_weights(load_torch_fit_checkpoint(str(path), expected, prefer_ema=False), sd, sd.values())
    raw, used = resolve_reference_state_dict(str(path), prefer_ema=False)
    assert not used and list(raw) == list(sd)


def test_ema_from_sidecar_file(tmp_path):
    sd, ema, opt_state = _ema_parts()
    main = tmp_path / "last.ckpt"
    torch.save({"state_dict": sd, "optimizer_states": [{"opt": {}}]}, main)
    torch.save({"optimizer_states": [opt_state]}, tmp_path / "last-EMA.ckpt")
    got, used = resolve_reference_state_dict(str(main))
    assert used
    _assert_weights(convert_torch_fit_state_dict(got), sd, ema)


def test_ema_sidecar_with_a_state_dict(tmp_path):
    sd, ema, _ = _ema_parts()
    torch.save({"state_dict": sd}, tmp_path / "last.ckpt")
    torch.save({"state_dict": dict(zip(sd, ema))}, tmp_path / "last-EMA.ckpt")
    _assert_weights(load_torch_fit_checkpoint(str(tmp_path / "last.ckpt")), sd, ema)


def test_ema_file_is_its_own_weights(tmp_path):
    sd, _, _ = _ema_parts()
    path = tmp_path / "last-EMA.ckpt"
    torch.save({"state_dict": sd}, path)
    got, used = resolve_reference_state_dict(str(path))
    assert used
    _assert_weights(convert_torch_fit_state_dict(got), sd, sd.values())


def test_plain_state_dict_without_ema(tmp_path):
    sd = reference_state_dict(5, "")
    torch.save(sd, tmp_path / "weights.pt")
    got, used = resolve_reference_state_dict(str(tmp_path / "weights.pt"))
    assert not used
    _assert_weights(convert_torch_fit_state_dict(got), sd, sd.values())


def test_ema_shape_mismatch_raises(tmp_path):
    sd, ema, opt_state = _ema_parts()
    opt_state["ema"] = [torch.zeros(3, 3)] * len(ema)
    torch.save({"state_dict": sd, "optimizer_states": [opt_state]}, tmp_path / "bad.ckpt")
    with pytest.raises(ValueError, match="shape mismatch at model.x_embedder.weight"):
        resolve_reference_state_dict(str(tmp_path / "bad.ckpt"))


def test_ema_count_mismatch_raises(tmp_path):
    sd, ema, opt_state = _ema_parts()
    opt_state["ema"] = ema[:-1]
    torch.save({"state_dict": sd, "optimizer_states": [opt_state]}, tmp_path / "bad.ckpt")
    with pytest.raises(ValueError, match="cannot map EMA weights"):
        resolve_reference_state_dict(str(tmp_path / "bad.ckpt"))


def test_missing_unknown_and_misshapen_keys_raise():
    expected = port_model().state_dict()
    sd = reference_state_dict(6)
    missing = dict(sd)
    del missing["model._orig_mod.blocks.1.ffn.fc2.bias"]
    with pytest.raises(KeyError, match=r"missing keys \['blocks.1.ffn.fc2.bias'\]"):
        convert_torch_fit_state_dict(missing, expected)
    unknown = dict(sd, **{"model.pos_embed": torch.zeros(1)})
    with pytest.raises(KeyError, match=r"unknown keys \['pos_embed'\]"):
        convert_torch_fit_state_dict(unknown, expected)
    misshapen = dict(sd)
    misshapen["model._orig_mod.final_layer.linear.weight"] = torch.zeros(32, HID)
    with pytest.raises(ValueError, match="shape mismatch at final.linear.weight"):
        convert_torch_fit_state_dict(misshapen, expected)
