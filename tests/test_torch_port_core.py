"""fit_tpu_torch.core against fit_tpu.core: the numpy tables are byte-equal
(the same arithmetic in the same order), and the torch patch geometry equals
the jnp one exactly (pure reshapes and copies)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fit_tpu.core import geometry as jgeo
from fit_tpu.core import pos_embed as jpos
from fit_tpu.core import schedules as jsch
from fit_tpu_torch.core import geometry as tgeo
from fit_tpu_torch.core import pos_embed as tpos
from fit_tpu_torch.core import schedules as tsch


def _byte_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize(
    "dim,nh,nw,max_length",
    [
        (16, 8, 8, None),
        (72, 16, 16, None),
        (72, 12, 20, 256),  # within the budget: NTK is the identity, table is float64
        (72, 32, 32, 256),  # 512^2 extrapolation: NTK rescales theta
        (64, 48, 48, 256),
    ],
)
def test_rope_freqs_2d_byte_equal(dim, nh, nw, max_length):
    _byte_equal(
        tpos.rope_freqs_2d(dim, nh, nw, max_length=max_length),
        jpos.rope_freqs_2d(dim, nh, nw, max_length=max_length),
    )


def test_ntk_scaled_theta_equal():
    pos = np.arange(40, dtype=np.float32)
    assert tpos.ntk_scaled_theta(10000.0, 36, pos, 256) == jpos.ntk_scaled_theta(
        10000.0, 36, pos, 256
    )


@pytest.mark.parametrize("dim,nh,nw", [(96, 8, 8), (1152, 16, 16), (64, 6, 10)])
def test_sincos_2d_byte_equal(dim, nh, nw):
    _byte_equal(tpos.sincos_2d(dim, nh, nw), jpos.sincos_2d(dim, nh, nw))


@pytest.mark.parametrize("name,steps", [("linear", 1000), ("linear", 250), ("squaredcos_cap_v2", 1000)])
def test_schedule_tables_byte_equal(name, steps):
    betas = tsch.named_beta_schedule(name, steps)
    _byte_equal(betas, jsch.named_beta_schedule(name, steps))
    tc, jc = tsch.compute_coefficients(betas), jsch.compute_coefficients(betas)
    for field in tc.__dataclass_fields__:
        _byte_equal(getattr(tc, field), getattr(jc, field))


@pytest.mark.parametrize("spacing", ["10", "250", "ddim50", "10,20,5", [3, 4]])
def test_respacing_equal(spacing):
    assert tsch.space_timesteps(1000, spacing) == jsch.space_timesteps(1000, spacing)
    keep = tsch.space_timesteps(1000, spacing)
    base = tsch.named_beta_schedule("linear", 1000)
    for t_arr, j_arr in zip(tsch.respaced_betas(base, keep), jsch.respaced_betas(base, keep)):
        _byte_equal(t_arr, j_arr)


@pytest.mark.parametrize("p,h,w", [(2, 16, 16), (2, 12, 20), (4, 16, 8)])
def test_patchify_roundtrip_equals_jnp(p, h, w):
    x = np.random.default_rng(0).normal(size=(3, 4, h, w)).astype(np.float32)
    got = tgeo.patchify(torch.from_numpy(x), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgeo.patchify(jnp.asarray(x), p)))
    back = tgeo.unpatchify(got, h, w, p, 4)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jgeo.unpatchify(jgeo.patchify(jnp.asarray(x), p), h, w, p, 4))
    )
    np.testing.assert_array_equal(back.numpy(), x)
    assert tgeo.token_count(h, w, p) == jgeo.token_count(h, w, p)


@pytest.mark.parametrize("h,w", [(16, 16), (12, 20), (8, 10), (32, 32)])
def test_pad_unpad_equals_jnp(h, w):
    p, max_size, max_length = 2, 16, 64
    x = np.random.default_rng(1).normal(size=(2, 4, h, w)).astype(np.float32)
    canvas = tgeo.pad_latent_to_canvas(torch.from_numpy(x), p, max_size, max_length)
    jcanvas = jgeo.pad_latent_to_canvas(jnp.asarray(x), p, max_size, max_length)
    np.testing.assert_array_equal(canvas.numpy(), np.asarray(jcanvas))
    valid_t = tgeo.token_count(h, w, p)
    got = tgeo.unpad_latent(canvas, valid_t, h, w, p)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jgeo.unpad_latent(jcanvas, valid_t, h, w, p))
    )
    np.testing.assert_array_equal(got.numpy(), x)
