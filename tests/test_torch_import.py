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
        "import liteattention_torch.utils.generation, liteattention_torch.utils.pretrained\n"
        "import liteattention_torch.utils.padding, liteattention_torch.ops.segments\n"
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


# Public names of the JAX package that the port does not have yet: none
# since the varlen functions.
NOT_PORTED = set()


# Names of the JAX ops and models packages that the port does not have yet
# (ROADMAP queue A): the psum-merge and the unmerged vote oracle, the
# TPU-only schedule unpacker, and the ViT model.
NOT_PORTED_SUBPACKAGES = {
    "skip_votes_ref",
    "combine_attention_psum",
    "unpack_schedule",
    "ViTConfig",
    "VisionTransformer",
}

# Names the port's subpackages export beside JAX's: the two ALiBi families'
# configs, which the JAX package keeps in models/configs.py only.
PORT_EXTRAS = {"models/__init__.py": {"baichuan_config", "btlm_config"}}


@pytest.mark.parametrize(
    "relpath", ["__init__.py", "flash_attn_interface.py", "ops/__init__.py", "models/__init__.py"]
)
def test_exports_match_the_jax_package(relpath):
    import importlib

    module = "liteattention_torch." + relpath.removesuffix(".py").replace("/", ".")
    module = module.removesuffix(".__init__")
    port = importlib.import_module(module)
    jax_names = set(_jax_all(relpath))
    if relpath.count("/"):
        # The subpackages export extras of the port's own (denoise,
        # skip_votes_ref_gather, ...): every JAX name that is ported must
        # be there.
        want = (jax_names - NOT_PORTED_SUBPACKAGES) | PORT_EXTRAS.get(relpath, set())
        assert want <= set(port.__all__), sorted(want - set(port.__all__))
        assert not NOT_PORTED_SUBPACKAGES & set(port.__all__)
    else:
        want = jax_names - NOT_PORTED
        assert set(port.__all__) == want
    assert all(callable(getattr(port, name)) or name == "ops" for name in want)


def test_ops_paged_attention_is_the_function():
    import types

    import liteattention_torch.ops as ops

    assert callable(ops.paged_attention)
    assert not isinstance(ops.paged_attention, types.ModuleType)
    from liteattention_torch.ops.paged_attention import paged_attention

    assert ops.paged_attention is paged_attention
