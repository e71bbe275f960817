"""Every public name of fit_tpu's subpackages imports from the port's.

For each subpackage that the port has, each name in ``fit_tpu.<pkg>.__all__``
must import from ``fit_tpu_torch.<pkg>``. ``NOT_PORTED`` names what the port
still owes, by its ROADMAP Queue 1 item; it must name only what is missing,
so that a port of it shows here.
"""

from __future__ import annotations

import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

PORTED = ("core", "data", "diffusion", "models", "ops", "train", "utils", "vae")
NOT_PORTED = {
    "models.MoeSwiGLU": "ROADMAP Queue 1 item 9 (MoE)",
    "eval": "ROADMAP Queue 1 item 6 (eval)",
    "parallel": "ROADMAP Queue 1 item 10 (parallel)",
}
REPO = Path(__file__).resolve().parents[1]


def _public_names():
    cases = []
    for pkg in PORTED:
        for name in importlib.import_module(f"fit_tpu.{pkg}").__all__:
            if f"{pkg}.{name}" not in NOT_PORTED:
                cases.append((pkg, name))
    return cases


@pytest.mark.parametrize("pkg,name", _public_names())
def test_port_exports_fit_tpu_name(pkg, name):
    module = importlib.import_module(f"fit_tpu_torch.{pkg}")
    ns = {}
    exec(f"from fit_tpu_torch.{pkg} import {name}", ns)
    assert ns[name] is getattr(module, name)
    assert name in module.__all__


def test_not_ported_names_only_what_is_missing():
    for what in NOT_PORTED:
        pkg, _, name = what.partition(".")
        ref = importlib.import_module(f"fit_tpu.{pkg}")
        if name:
            assert name in ref.__all__
            assert not hasattr(importlib.import_module(f"fit_tpu_torch.{pkg}"), name)
        else:
            assert (Path(ref.__file__).parent).is_dir()
            assert not (REPO / "fit_tpu_torch" / pkg).exists()
    ref_pkgs = {p.name for p in (REPO / "fit_tpu").iterdir() if (p / "__init__.py").is_file()}
    assert ref_pkgs - {"cli"} == set(PORTED) | {w for w in NOT_PORTED if "." not in w}


def test_port_version_and_exports_import_without_jax():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"  # any import of jax raises
        "import fit_tpu_torch\n"
        f"for p in {PORTED!r}:\n"
        "    m = importlib.import_module('fit_tpu_torch.' + p)\n"
        "    [getattr(m, n) for n in m.__all__]\n"
        "print(fit_tpu_torch.__version__)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True)
    import fit_tpu

    assert out.stdout.strip() == fit_tpu.__version__


def test_diffusion_from_enums_equals_boolean_form():
    from fit_tpu_torch.core.schedules import named_beta_schedule
    from fit_tpu_torch.diffusion import GaussianDiffusion, ModelMeanType, ModelVarType

    betas = named_beta_schedule("linear", 50)
    flags = {
        ModelVarType.FIXED_LARGE: {},
        ModelVarType.FIXED_SMALL: {"sigma_small": True},
        ModelVarType.LEARNED_RANGE: {"learn_sigma": True},
    }
    for mean, xstart in ((ModelMeanType.EPSILON, False), (ModelMeanType.START_X, True)):
        for var, kw in flags.items():
            by_enum = GaussianDiffusion(betas, model_mean_type=mean, model_var_type=var)
            by_bool = GaussianDiffusion(betas, predict_xstart=xstart, **kw)
            for d in (by_enum, by_bool):
                assert (d.model_mean_type, d.model_var_type) == (mean, var)
            for attr in ("predict_xstart", "sigma_small", "learn_sigma", "num_timesteps", "original_num_steps"):
                assert getattr(by_enum, attr) == getattr(by_bool, attr)
            np.testing.assert_array_equal(by_enum.betas, by_bool.betas)
    with pytest.raises(ValueError):
        GaussianDiffusion(betas, model_mean_type=ModelMeanType.PREVIOUS_X)
    with pytest.raises(ValueError):
        GaussianDiffusion(betas, model_var_type=ModelVarType.LEARNED)
    with pytest.raises(ValueError):
        GaussianDiffusion(betas, sigma_small=True, model_var_type=ModelVarType.LEARNED_RANGE)
    with pytest.raises(ValueError):
        GaussianDiffusion(betas, predict_xstart=True, model_mean_type=ModelMeanType.EPSILON)


def test_aliases_are_the_same_objects():
    from fit_tpu_torch import core, vae
    from fit_tpu_torch.core import pos_embed
    from fit_tpu_torch.vae import convert

    assert core.get_1d_sincos_pos_embed is pos_embed.sincos_1d
    assert core.get_2d_sincos_pos_embed is pos_embed.sincos_2d
    assert core.precompute_freqs_cis_2d is pos_embed.rope_freqs_2d
    assert vae.convert_torch_state_dict is convert.convert_state_dict
    assert vae.load_torch_checkpoint is convert.load_checkpoint


def test_new_names_match_fit_tpu():
    """The names the port adds here against fit_tpu's on the same inputs:
    the 1D tables bit for bit, the enums by member, apply_rope on seeded
    (B, H, T, d) operands."""
    import jax.numpy as jnp
    import torch

    import fit_tpu.core as ref_core
    import fit_tpu.diffusion as ref_diff
    from fit_tpu.models import apply_rope as ref_apply_rope
    from fit_tpu_torch import core, diffusion
    from fit_tpu_torch.models import apply_rope

    np.testing.assert_array_equal(core.sincos_1d(32, 17), ref_core.sincos_1d(32, 17))
    pos = np.arange(40, dtype=np.float32) * 0.5
    for max_length in (None, 16):
        np.testing.assert_array_equal(
            core.rope_freqs_1d_from_positions(16, pos, max_length=max_length),
            ref_core.rope_freqs_1d_from_positions(16, pos, max_length=max_length),
        )
    for enum_name in ("ModelMeanType", "ModelVarType"):
        assert [m.name for m in getattr(diffusion, enum_name)] == [m.name for m in getattr(ref_diff, enum_name)]

    rng = np.random.default_rng(0)
    b, h, side, d = 2, 3, 4, 16
    q, k = (rng.standard_normal((b, h, side * side, d)).astype(np.float32) for _ in range(2))
    fc = np.broadcast_to(core.rope_freqs_2d(d, side, side), (b, side * side, d)).copy()
    got = apply_rope(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(fc))
    want = ref_apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(fc))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
