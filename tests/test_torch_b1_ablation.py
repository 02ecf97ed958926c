"""b1_ablation.py's variants still apply to the committed B1 kernel: each
edit finds its text in ``csrc/flash_fwd.cu`` (an edit that no longer
matches fails the tool on the card) and changes the source."""

import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("b1_ablation", ROOT / "b1_ablation.py")
b1_ablation = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(b1_ablation)


@pytest.mark.parametrize("name", [n for n, f in b1_ablation.VARIANTS.items() if f is not None])
def test_variant_edits_apply(name):
    src = (b1_ablation.CSRC / b1_ablation.FWD).read_text()
    out = b1_ablation.VARIANTS[name](src)
    assert out != src
    assert "extern \"C\" int lite_flash_fwd_dense(" in out


def _launch_function(src):
    """(template parameter names, body) of flash_fwd.cu's host ``launch``."""
    import re

    m = re.search(r"template <([^>]*)>\ncudaError_t launch\(Kernel kernel,.*?\n\}\n", src, re.S)
    assert m, "flash_fwd.cu: no launch(Kernel kernel, ...) found"
    params = {p.split()[-1].split("=")[0].strip() for p in m.group(1).split(",")}
    params |= {p.split("=")[0].split()[-1] for p in m.group(1).split(",") if "=" in p}
    return params, m.group(0)


def _undeclared_in_launch(src):
    """Upper-case identifiers (template parameters, macros) that the host
    ``launch`` names but neither declares as its own template parameters nor
    finds defined at file scope (a ``#define`` or a ``constexpr``)."""
    import re

    params, body = _launch_function(src)
    names = set(re.findall(r"\b[A-Z][A-Z0-9_]*[A-Z0-9]\b", body.split("\n", 2)[2]))
    defined = set(re.findall(r"#define\s+([A-Z][A-Z0-9_]*)", src))
    defined |= set(re.findall(r"^constexpr\s+\w+\s+([A-Z][A-Z0-9_]*)\b", src, re.M))
    return sorted(names - params - defined)


@pytest.mark.parametrize("name", list(b1_ablation.VARIANTS))
def test_variant_launch_names_only_its_own_parameters(name):
    # A launch edit that names a kernel's template parameter (CAUSAL)
    # compiles nowhere: the host launch takes only its own.
    src = (b1_ablation.CSRC / b1_ablation.FWD).read_text()
    fn = b1_ablation.VARIANTS[name]
    assert _undeclared_in_launch(fn(src) if fn else src) == []


def test_the_launch_check_catches_an_undeclared_identifier():
    src = (b1_ablation.CSRC / b1_ablation.FWD).read_text()
    broken = b1_ablation.edit(src, b1_ablation.LAUNCH,
                              b1_ablation.LAUNCH.replace("p.qtiles", "(CAUSAL ? p.qtiles : 1)"))
    assert _undeclared_in_launch(broken) == ["CAUSAL"]
