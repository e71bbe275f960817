"""The card-side tools, on the CPU: what they parse, and that they refuse
to run without a card.

``ops/_build.py`` reads each kernel's registers and spills from ptxas's
log (the card tests fail on a spill), ``cli.kernel_times`` and
``cli.profile_train`` time the card and exit without one, and the card
tests' seeded InceptionV3 loads in both packages.
"""

import pytest
import torch

from fit_tpu_torch.cli import kernel_times, profile_train
from fit_tpu_torch.ops import _build

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
    tf32 = _build.ptxas_usage(log, r"bwd_(dkdv|dq)_tf32_kernelILi(\d+)E")
    mma = _build.ptxas_usage(log, r"bwd_(dkdv|dq)_mma_kernelILi(\d+)E")
    assert tf32 == {("dkdv", 80): {"spill_stores": 0, "spill_loads": 0, "registers": 232},
                    ("dq", 64): {"spill_stores": 0, "spill_loads": 0, "registers": 168}}
    assert set(mma) == {("dkdv", 80), ("dq", 128)} and mma[("dq", 128)]["spill_stores"] == 8


def test_no_spill_check_fails_on_a_guarded_spill_or_a_missing_instantiation():
    found = {("dq", 64): {"registers": 200, "spill_stores": 0, "spill_loads": 0},
             ("dq", 128): {"registers": 255, "spill_stores": 4, "spill_loads": 4}}
    _build.check_no_spill(found, 2, lambda k: k[1] in (64, 80))  # DP 128 is not guarded
    with pytest.raises(RuntimeError, match="spills"):
        _build.check_no_spill(found, 2, lambda k: True)
    with pytest.raises(RuntimeError, match="1 of 2"):
        _build.check_no_spill({("dq", 64): found[("dq", 64)]}, 2, lambda k: True)


@pytest.mark.parametrize(
    "main,argv",
    [
        (kernel_times.main, ["--baseline", "build/parent"]),
        (profile_train.main, ["--dtype", "float32", "--steps", "1"]),
    ],
    ids=["kernel_times", "profile_train"],
)
def test_card_tools_refuse_to_run_without_a_card(monkeypatch, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code != 0


def test_profile_train_rejects_an_unknown_dtype():
    with pytest.raises(SystemExit) as exc:
        profile_train.main(["--dtype", "float16"])
    assert exc.value.code == 2


def test_phase10_inception_state_loads_in_both_packages():
    """The card tests' seeded InceptionV3 has pytorch-fid's module names:
    both packages' converters take every key it has, and the port's keeps
    the 1008-way fc."""
    from test_torch_port_cuda import seeded_inception_state

    from fit_tpu.eval import inception as ref_inc
    from fit_tpu_torch.eval import inception

    sd = seeded_inception_state()
    model = inception.convert_torch_inception(sd)
    params = ref_inc.convert_torch_inception({k: v.numpy() for k, v in sd.items()})
    assert model.fc.out_features == 1008 and params["fc"]["kernel"].shape == (2048, 1008)
    convs = [n for n, m in model.named_modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(sd) == 5 * len(convs) + 2 and all(f"{n}.bn.running_var" in sd for n in convs)
