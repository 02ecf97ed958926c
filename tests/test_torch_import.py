"""The port imports torch and never jax, flax or the JAX package: it must
import with them blocked, and no module of the package (nor
chip_smoke.py) may name them in an import."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "liteattention_torch"
BLOCKED = ("jax", "flax", "liteattention_tpu")


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'liteattention_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import liteattention_torch, liteattention_torch.models, liteattention_torch.train\n"
        "import liteattention_torch.modules, liteattention_torch.training\n"
        "from liteattention_torch.ops import _build, flash_bwd, norms, activations\n"
        "from liteattention_torch.ops import flash_decode, paged_attention, kv_quant, combine\n"
        "import liteattention_torch.flash_attn_interface, liteattention_torch.layers\n"
        "import liteattention_torch.flash_blocksparse\n"
        "from liteattention_torch.ops import kv_compact, lite_flash_fwd, schedule_pack\n"
        "import liteattention_torch.utils.generation\n"
        "import chip_smoke\n"
        "loaded = {m.split('.')[0] for m in sys.modules if sys.modules[m]}\n"
        "assert not loaded & {'jax', 'flax', 'liteattention_tpu'}, loaded\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "b1_ablation.py"],
    ids=lambda p: p.name,
)
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in BLOCKED, (path, name)


def _jax_all(relpath):
    """``__all__`` of a JAX-package module, read from its source (JAX is
    not imported here)."""
    tree = ast.parse((ROOT / "liteattention_tpu" / relpath).read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "__all__":
            return ast.literal_eval(node.value)
    raise AssertionError(f"no __all__ in {relpath}")


# Public names of the JAX package that the port does not have yet (ROADMAP A13).
NOT_PORTED = {
    "flash_attn_varlen_func",
    "flash_attn_varlen_qkvpacked_func",
    "flash_attn_varlen_kvpacked_func",
}


@pytest.mark.parametrize("relpath", ["__init__.py", "flash_attn_interface.py"])
def test_exports_match_the_jax_package(relpath):
    import importlib

    module = "liteattention_torch" + ("" if relpath == "__init__.py" else ".flash_attn_interface")
    port = importlib.import_module(module)
    want = set(_jax_all(relpath)) - NOT_PORTED
    assert set(port.__all__) == want
    assert all(callable(getattr(port, name)) or name == "ops" for name in want)
