"""The chip-side measuring tools, on the CPU: what they parse and count.

``chip_smoke.py`` reads each kernel's registers and spills from ptxas's
log, ``fit_tpu_torch.cli.k2_fp32_ab`` computes the fp32 K2's bound from its
shapes, and every tool that times the card refuses to run without one.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from fit_tpu_torch.cli import k2_fp32_ab, profile_train  # noqa: E402

PREFIX = "_ZN54_GLOBAL__N__a103f193_21_rope_attention_bwd_cu_c335c651"


def ptxas_log(entries) -> str:
    """A ptxas -v log of (mangled kernel name, registers, spill bytes)."""
    lines = []
    for name, regs, spill in entries:
        lines += [
            f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads",
            f"ptxas info    : Used {regs} registers, used 1 barriers",
        ]
    return "\n".join(lines)


def test_ptxas_parsers_tell_the_k2_passes_apart():
    log = ptxas_log([
        (f"{PREFIX}20bwd_dkdv_tf32_kernelILi80EEEvPKfS2_", 232, 0),
        (f"{PREFIX}18bwd_dq_tf32_kernelILi64EEEvPKfS2_", 168, 0),
        (f"{PREFIX}19bwd_dkdv_mma_kernelILi80EEEvPK13__nv_bfloat16", 232, 0),
        (f"{PREFIX}17bwd_dq_mma_kernelILi128EEEvPK13__nv_bfloat16", 204, 8),
        (f"{PREFIX}19bwd_prologue_kernelIfEEvPKT_S3_", 40, 0),
    ])
    tf32 = chip_smoke.k2_tf32_ptxas(log)
    mma = chip_smoke.k2_mma_ptxas(log)
    assert tf32 == {("dkdv", 80): {"spill_stores": 0, "spill_loads": 0, "registers": 232},
                    ("dq", 64): {"spill_stores": 0, "spill_loads": 0, "registers": 168}}
    assert set(mma) == {("dkdv", 80), ("dq", 128)} and mma[("dq", 128)]["spill_stores"] == 8


def test_no_spill_check_fails_on_a_guarded_spill_or_a_missing_instantiation():
    found = {("dq", 64): {"registers": 200, "spill_stores": 0, "spill_loads": 0},
             ("dq", 128): {"registers": 255, "spill_stores": 4, "spill_loads": 4}}
    chip_smoke.check_no_spill("K2", found, lambda k: k[1] in chip_smoke.NO_SPILL_DPS, 2)  # DP 128 is not guarded
    with pytest.raises(AssertionError, match="spills"):
        chip_smoke.check_no_spill("K2", found, lambda k: True, 2)
    with pytest.raises(AssertionError, match="1 of 2"):
        chip_smoke.check_no_spill("K2", {("dq", 64): found[("dq", 64)]}, lambda k: True, 2)


@pytest.mark.parametrize(
    "name,basis,want_us,by",
    [
        ("FiT-B/2 B64 T256 H12 d64", "tf32x3", 122.9, "bytes"),
        ("FiT-B/2 B64 T256 H12 d64", "fma", 250.7, "operations"),
        ("XL B1 T4096 H16 d72", "tf32x3", 1143.9, "operations"),
    ],
)
def test_fp32_k2_bound(name, basis, want_us, by):
    """The bounds PERF.md gives beside the fp32 K2: qkv, g, out, lse and the
    tables read once, dqkv written once, 5 products over the valid keys."""
    bound = k2_fp32_ab.bounds_ms(*k2_fp32_ab.SHAPES[name])[basis]
    assert bound[0] * 1e3 == pytest.approx(want_us, abs=0.05) and bound[1] == by


@pytest.mark.parametrize("case,name", [(0, "FiT-B/2 B64 T256 H12 d64"), (3, "XL B16 T256 H16 d72"),
                                       (5, "XL B2 T2304 H16 d72"), (6, "XL B1 T4096 H16 d72")])
def test_fp32_k2_shapes_and_bounds_agree_with_chip_smoke(case, name):
    """k2_fp32_ab times the shapes of chip_smoke.py's phase 6a, with its bound."""
    h, d, b, t, lengths = chip_smoke.GRAD_SHAPES[case]
    assert (h, d, b, t, lengths) == k2_fp32_ab.SHAPES[name]
    (_, _), (bwd, by) = chip_smoke.attention_bounds(b, t, h, d, lengths, torch.float32)
    assert (bwd, by) == pytest.approx(k2_fp32_ab.bounds_ms(h, d, b, t, lengths)["tf32x3"])


@pytest.mark.parametrize(
    "main,argv",
    [
        (k2_fp32_ab.main, ["--baseline", "build/parent"]),
        (profile_train.main, ["--dtype", "float32", "--steps", "1"]),
        (chip_smoke.main, None),
    ],
    ids=["k2_fp32_ab", "profile_train", "chip_smoke"],
)
def test_card_tools_refuse_to_run_without_a_card(monkeypatch, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        main() if argv is None else main(argv)
    assert exc.value.code != 0


def test_profile_train_rejects_an_unknown_dtype():
    with pytest.raises(SystemExit) as exc:
        profile_train.main(["--dtype", "float16"])
    assert exc.value.code == 2


def test_phase10_inception_state_loads_in_both_packages():
    """Phase 10's seeded InceptionV3 has pytorch-fid's module names: both
    packages' converters take every key it has, and the port's keeps the
    1008-way fc."""
    from fit_tpu.eval import inception as ref_inc
    from fit_tpu_torch.eval import inception

    sd = chip_smoke.seeded_inception_state()
    model = inception.convert_torch_inception(sd)
    params = ref_inc.convert_torch_inception({k: v.numpy() for k, v in sd.items()})
    assert model.fc.out_features == 1008 and params["fc"]["kernel"].shape == (2048, 1008)
    convs = [n for n, m in model.named_modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(sd) == 5 * len(convs) + 2 and all(f"{n}.bn.running_var" in sd for n in convs)


def test_phase10_inception_flops_match_torchs_flop_counter():
    """The hooks' count of one image's convolutions and fc head equals
    ``torch.utils.flop_counter`` on the same pass (2 per multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode

    from fit_tpu_torch.eval import inception

    model = inception.convert_torch_inception(chip_smoke.seeded_inception_state())
    with FlopCounterMode(display=False) as counter, torch.inference_mode():
        model.logits(model(torch.zeros((1, 3, 299, 299)))[0])
    assert chip_smoke.inception_flops(model) == counter.get_total_flops()
    assert 11.0e9 < counter.get_total_flops() < 12.0e9  # InceptionV3's ~5.7 G multiply-adds


def test_phase10_parses_cli_fid_lines():
    out = ("extracted features for 64 images from x\nFID: 12.3456\nsFID: 7.5000\n"
           "Inception Score: 1.0100 +/- 0.0020\nPrecision: 0.2500  Recall: 0.7500\n")
    assert chip_smoke.parse_metric_lines(out) == {
        "FID": [12.3456], "sFID": [7.5], "IS": [1.01, 0.002], "PR": [0.25, 0.75]}
    assert chip_smoke.parse_metric_lines("FID: 1.0\n") == {"FID": [1.0]}
