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
