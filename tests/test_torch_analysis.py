"""The reference's static checker (``repro.analysis``) over the port.

Its rules apply to ``src/repro_torch`` as they stand (clock discipline,
the ``_GUARDED_BY`` lock registries of the engine, batcher, dispatcher,
supervisor, metrics, futures, trace and fault modules, frozen specs,
``__all__`` exports): the port must give no finding, the mesh runtime's
shared state included.  No rule is edited for the port.

The port's own rule, ``repro_torch.analysis.cuda_abi``, holds the kernels'
``extern "C"`` launch signatures in ``kernels/csrc``, from which
``_build`` reads the ctypes argument types, and the wrappers'
``_build.entry`` calls against them: it finds nothing in the tree, sees
every entry, and names each fault seeded into a temporary copy.
``_build`` itself derives the argument types from the C signature and
refuses a launch with another number of arguments.
"""
from pathlib import Path

import pytest

from repro.analysis import rule_registry, run_analysis

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.mark.parametrize("rule", sorted(rule_registry()))
def test_port_has_no_finding(rule):
    findings = run_analysis([PORT], rules=[rule])
    assert not findings, "\n".join(str(f) for f in findings)


# -- the port's own rule: the kernels' C entry points and their bindings ----

def test_cuda_abi_rule_covers_every_entry_and_finds_nothing():
    from repro_torch.analysis import check_cuda_abi
    from repro_torch.analysis.cuda_abi import KERNELS, c_signatures
    checked = []
    assert check_cuda_abi(checked=checked) == []
    entries = {e for per in c_signatures(KERNELS / "csrc").values()
               for e in per}
    assert {e for _, _, e in checked} == entries
    assert len(entries) == 9
    # every wrapper module that launches a kernel has its calls resolved
    assert {f for f, _, _ in checked} == {"spiking_conv.py",
                                         "spiking_conv_lif.py", "lif.py"}


# (file, text to find, its replacement, words the finding must hold)
ABI_MUTATIONS = [
    ("csrc/lif_bwd.cu", "int T, long long M, int kind",
     "int T, double M, int kind", "no ctypes kind: ['unknown (double)']"),
    ("csrc/lif_fused.cu", "float v_th, void* stream) {",
     "float v_th) {", "lif_fused_launch's last parameter is not void*"),
    ("csrc/conv_grad_input.cu", "extern \"C\" int conv_grad_input_launch(",
     "extern \"C\" int conv_grad_input_run(",
     "conv_grad_input_launch is not an extern"),
    ("spiking_conv_lif.py", "\"spiking_conv_lif_fwd_launch\" if save_u",
     "\"spiking_conv_lif_fwd\" if save_u",
     "spiking_conv_lif_fwd is not an extern \"C\" function of "
     "csrc/spiking_conv_lif.cu"),
    ("lif.py", "_build.entry(\"lif_fused\")", "_build.entry(fn)",
     "_build.entry(fn) does not name its source and entry point"),
    ("spiking_conv.py",
     "\"spiking_conv\", \"spiking_conv_lif_hoisted_launch\"",
     "\"spiking_conv_lif\", \"spiking_conv_lif_hoisted_launch\"",
     "spiking_conv_lif_hoisted_launch is not an extern \"C\" function of "
     "csrc/spiking_conv_lif.cu"),
]


@pytest.mark.parametrize("case", range(len(ABI_MUTATIONS)))
def test_cuda_abi_rule_catches_a_seeded_mismatch(tmp_path, case):
    """A copy of the kernels with one declaration broken: the rule names
    it (the tree itself stays as it is)."""
    import shutil

    from repro_torch.analysis import check_cuda_abi
    from repro_torch.analysis.cuda_abi import KERNELS
    name, old, new, words = ABI_MUTATIONS[case]
    copy = tmp_path / "kernels"
    shutil.copytree(KERNELS, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = copy / name
    text = path.read_text()
    assert text.count(old) == 1, old
    path.write_text(text.replace(old, new))
    findings = [str(f) for f in check_cuda_abi(copy)]
    assert any(words in f for f in findings), findings
    assert check_cuda_abi() == []


# -- _build: the argument types come from the C signature --------------------

@pytest.mark.parametrize("entry,want", [
    ("lif_bwd", ["c_void_p"] * 5 + ["c_int", "c_longlong", "c_int",
                                    "c_float", "c_float", "c_void_p"]),
    ("lif_fused", ["c_void_p"] * 4 + ["c_longlong", "c_int", "c_float",
                                      "c_void_p"]),
    ("conv_grad_input", ["c_void_p"] * 3 + ["c_int"] * 11 + ["c_void_p"]),
])
def test_argtypes_follow_the_c_signature(entry, want):
    import ctypes

    from repro_torch.kernels import _build
    assert _build.argtypes(entry) == [getattr(ctypes, t) for t in want]


def test_argtypes_refuse_a_missing_entry():
    from repro_torch.kernels import _build
    with pytest.raises(ValueError, match="spiking_conv_fwd_launch is not"):
        _build.argtypes("spiking_conv", "spiking_conv_fwd_launch")


@pytest.mark.parametrize("n_args", [2, 4])
def test_launch_refuses_another_argument_count(n_args):
    """A launch with one argument too few or too many raises before it
    reaches the device (ctypes would pass extra ones on unchecked)."""
    import torch

    from repro_torch.kernels import _build

    def never_called(*args):
        raise AssertionError("the launch function was called")

    with pytest.raises(TypeError, match=f"{n_args} arguments before the "
                       f"stream, its launch function takes 3"):
        _build.launch(torch.device("cuda", 0), "f",
                      (None, never_called, 3), *range(n_args))
