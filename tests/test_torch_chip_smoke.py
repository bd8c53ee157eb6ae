"""chip_smoke.py's phase 2 reads ptxas's report and cuobjdump's SASS by
kernel name: every instantiation it checks (CHECKED_KERNELS: the bf16
tensor-core kernels, the fp32 forward and the fp32 backward) must come back
from ``kernel_label`` under the name the check looks up, or the spill check
fails on the card with "ptxas printed no spill line".  The mangled names
here follow the Itanium C++ ABI as nvcc emits it for the kernels in
paddle_tpu_torch/csrc/ (anonymous namespace, then namespace tc or f32)."""
import importlib.util
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def _mangle(label):
    """The mangled name of the kernel `label` names: 'fa_dq_tc_kernel<bf16,
    128>' is namespace tc's fa_dq_tc_kernel<128>, 'fa_dkv_f32_kernel<64,
    4>' namespace f32's fa_dkv_f32_kernel<64, 4>; parameters as the
    kernels take them (TMA maps for tc, float pointers for f32)."""
    name, args = re.fullmatch(r"(\w+)<(.*)>", label).groups()
    args = [a.strip() for a in args.split(",")]
    if args[0] == "bf16":
        ns, ints, params = "tc", args[1:], "N6hopper7TmaMapsILi4EEEPKfS6_"
    else:
        ns, ints, params = "f32", args, "PKfS3_S3_S3_S3_S3_S3_PfS4_S4_"
    targs = "".join(f"Li{a}E" for a in ints)
    return (f"_ZN12_GLOBAL__N_1{len(ns)}{ns}{len(name)}{name}I{targs}EEv"
            f"{params}NS_8BwdShapeE")


def test_the_checked_kernels_cover_every_kernel_family():
    names = {re.match(r"\w+", k).group(0) for k in smoke.CHECKED_KERNELS}
    assert names == {"fa_fwd_tc_kernel", "fa_dq_tc_kernel",
                     "fa_dkv_tc_kernel", "fa_fwd_f32_kernel",
                     "fa_dkv_f32_kernel", "fa_dq_f32_kernel"}
    assert len(set(smoke.CHECKED_KERNELS)) == len(smoke.CHECKED_KERNELS)


@pytest.mark.parametrize("label", smoke.CHECKED_KERNELS)
def test_kernel_label_names_every_checked_instantiation(label):
    assert smoke.kernel_label(_mangle(label)) == label


@pytest.mark.parametrize("label", smoke.CHECKED_KERNELS)
def test_ptxas_report_finds_every_checked_instantiation(label):
    """ptxas's -v lines for one kernel, as nvcc prints them, land under
    the label check_build looks up, spill line included."""
    mangled = _mangle(label)

    class FakeBuild:
        build_logs = {"lib": "\n".join([
            f"ptxas info    : Compiling entry function '{mangled}' for "
            f"'sm_90a'",
            f"ptxas info    : Function properties for {mangled}",
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            "loads",
            "ptxas info    : Used 200 registers, used 1 barriers"])}

    report = smoke.ptxas_report(FakeBuild)
    assert list(report) == [label]
    assert any("0 bytes spill stores" in line for line in report[label])
