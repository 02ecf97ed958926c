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
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
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
