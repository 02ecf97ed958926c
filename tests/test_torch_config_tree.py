"""Port parity: training/config_tree.py against the JAX module, and its YAML
reader against PyYAML's ``safe_load``.

Every file under ``configs/`` composes to the JAX tree (equal as Python
values), alone and with group overrides (``experiment=gpt2s-moe``,
``model=llama-tiny``, ``experiment=null``), leaf overrides with ``+``, ``~``
and YAML values, and ``${a.b}`` interpolation. The reader equals
``yaml.safe_load`` on every file there and on the scalar forms the
overrides use; YAML it does not take raises ``YAMLError``. The CLI maps the
tree onto the trainer as the root ``train.py`` does. No tolerance: equality.
"""

import math
import os
import pathlib
import shutil

import pytest

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")

from liteattention_tpu.training import config_tree as jct  # noqa: E402
from liteattention_torch.training import config_tree as ct  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
ROOT_CFG = str(REPO / "configs" / "config.yaml")
CONFIG_FILES = sorted((REPO / "configs").rglob("*.yaml"))


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_reader_equals_safe_load_on_the_config_files(path):
    text = path.read_text()
    assert ct.parse_yaml(text, str(path)) == yaml.safe_load(text)


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_every_config_file_composes_as_jax(path):
    assert ct.compose(str(path)) == jct.compose(str(path))
    assert ct.load_config(str(path)) == jct.load_config(str(path))


OVERRIDE_SETS = [
    [],
    ["experiment=gpt2s-moe"],
    ["model=llama-tiny"],
    ["experiment=null"],
    ["model=llama-tiny", "experiment=gpt2s-moe"],
    ["optimizer.learning_rate=1e-4", "run.steps=7", "+run.note=hello",
     "~trainer.max_checkpoints"],
    ["+run.tag=run-${model.family}-${model.dim}", "+run.width=${model.dim}",
     "+run.missing=${no.such.key}"],
    ["trainer.grad_comm_dtype=bfloat16", "run.data=[1, 2, 'x']", "run.seed=0x10",
     "optimizer.beta2=.999", "trainer.norm_monitor=yes", "+run.empty=", "+run.q='a b'"],
    ["experiment=gpt2s-moe", "model.dim=768", "model.num_layers=12", "model.num_heads=12",
     "model.vocab=50257", "run.seqlen=1024", "run.batch_size=8", "run.steps=12",
     "optimizer.warmup_steps=2"],
]


@pytest.mark.parametrize("overrides", OVERRIDE_SETS, ids=lambda o: " ".join(o) or "none")
def test_load_config_with_overrides_equals_jax(overrides):
    got = ct.load_config(ROOT_CFG, overrides)
    assert got == jct.load_config(ROOT_CFG, overrides)


def test_override_values_and_numeric_fallback():
    cfg = ct.load_config(ROOT_CFG, OVERRIDE_SETS[5] + OVERRIDE_SETS[6])
    # YAML 1.1 reads 1e-4 as a string; the override takes it as a float.
    assert cfg["optimizer"]["learning_rate"] == 1e-4
    assert cfg["run"]["steps"] == 7 and cfg["run"]["note"] == "hello"
    assert "max_checkpoints" not in cfg["trainer"]
    assert cfg["run"]["tag"] == "run-gpt2-256" and cfg["run"]["width"] == 256
    assert cfg["run"]["missing"] == "${no.such.key}"
    with pytest.raises(KeyError):
        ct.load_config(ROOT_CFG, ["run.does_not_exist=1"])
    with pytest.raises(ValueError):
        ct.load_config(ROOT_CFG, ["run.steps"])


def test_global_package_experiment_patches_across_groups():
    cfg = ct.load_config(ROOT_CFG, ["experiment=gpt2s-moe"])
    assert cfg["model"]["moe_experts"] == 4
    assert cfg["optimizer"]["learning_rate"] == 6e-4
    assert cfg["run"]["steps"] == 50
    assert "experiment" not in cfg


def test_nested_groups_self_position_and_null(tmp_path):
    # A tree of our own: a nested group (group/sub), _self_ first (the
    # groups win over the root body), group: null, a group file with
    # defaults of its own, an interpolation across groups.
    root = tmp_path / "conf"
    shutil.copytree(REPO / "configs", root)
    (root / "data" / "owt").mkdir(parents=True)
    (root / "data" / "owt" / "small.yaml").write_text("tokens: 1000\nname: owt-${run.seed}\n")
    (root / "sched").mkdir()
    (root / "sched" / "cos.yaml").write_text(
        "defaults:\n  - _self_\n  - warm: short\nkind: cosine\n")
    (root / "sched" / "warm").mkdir()
    (root / "sched" / "warm" / "short.yaml").write_text("steps: 5\n")
    (root / "top.yaml").write_text(
        "defaults:\n- _self_\n- data/owt: small\n- sched: cos\n- model: gpt2s\n"
        "- trainer: null\nrun:\n  seed: 3\nmodel:\n  dim: 1\n")
    for overrides in ([], ["model=llama-tiny"], ["sched=null"]):
        got = ct.load_config(str(root / "top.yaml"), overrides)
        assert got == jct.load_config(str(root / "top.yaml"), overrides)
    got = ct.load_config(str(root / "top.yaml"))
    assert got["data"]["owt"] == {"tokens": 1000, "name": "owt-3"}
    assert got["model"]["dim"] == 256  # _self_ first: the group wins
    assert got["sched"] == {"kind": "cosine", "warm": {"steps": 5}}
    assert "trainer" not in got


def test_interpolation_merge_select_and_flat_kwargs():
    tree = {"a": {"x": 4, "name": "run-${a.x}"}, "b": "${a.x}", "keep": "${not.there}"}
    want = jct.resolve_interpolations(dict(tree, a=dict(tree["a"])))
    assert ct.resolve_interpolations(tree) == want
    assert tree["b"] == 4 and tree["a"]["name"] == "run-4"
    dst = {"m": {"a": 1, "b": 2}, "l": [1, 2]}
    ct.merge_trees(dst, {"m": {"b": 3}, "l": [9]})
    assert dst == {"m": {"a": 1, "b": 3}, "l": [9]}
    assert ct.select(dst, "m.b") == 3 and ct.select(dst, "m.zz", default="d") == "d"
    assert ct.to_flat_kwargs({"a": 1, "b": 2}, ["a"]) == {"a": 1}
    assert ct.to_flat_kwargs(None, ["a"]) == {}


SCALARS = ["1e-4", "1.0e4", "3.0e-4", "-2.5E-3", "0x1F", "0b101", "007", "08", "1_000", "+12",
           "-0", ".5", "0.", "-.inf", ".NaN", "yes", "No", "On", "off", "TRUE", "~", "null", "",
           "bfloat16", "gpt2s-moe", "'it''s'", '"a\\tb\\u00e9"', "[1, 2.5, x, [y, null]]", "[]",
           "hello world", "a#b", "http://x.y/z"]


@pytest.mark.parametrize("text", SCALARS)
def test_reader_resolves_scalars_as_safe_load(text):
    got, want = ct.parse_yaml(text), yaml.safe_load(text)
    if isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == want and type(got) is type(want)


DOCUMENTS = [
    "a: 1\nb:\n  c: [1, 2]\n  d: 'x # not a comment'  # a comment\n",
    "defaults:\n- _self_\n- model: gpt2s\n- experiment: null\n",
    "x:\n  -\n    y: 1\n  - - 2\n    - 3\n  - z: 4\n    w: 5\n",
    "# @package _global_\n\n# only a comment\nk: v\n",
    "'quoted key': 1\ntrue: 2\n3: three\n",
    "a:\n\n  b: 1\n\n",
    "",
]


@pytest.mark.parametrize("text", DOCUMENTS)
def test_reader_equals_safe_load_on_documents(text):
    assert ct.parse_yaml(text) == yaml.safe_load(text)


UNSUPPORTED = ["a: {b: 1}", "a: &x 1\nb: *x", "a: !!str 1", "a: |\n  text", "a: >\n  text",
               "a: b\n  continued", "---\na: 1", "%YAML 1.1\n---\na: 1", "a: 2001-12-14",
               "a: 1:30", "a:\n\t- x", "a: [b: 1]", "a: b: c", "a: 'open", "? a\n: b",
               "a: 1\n b: 2"]


@pytest.mark.parametrize("text", UNSUPPORTED)
def test_reader_raises_on_unsupported_yaml(text):
    with pytest.raises(ct.YAMLError):
        ct.parse_yaml(text)


def test_cli_maps_the_tree_onto_the_trainer_as_jax(monkeypatch):
    from liteattention_torch import train as train_cli

    args = train_cli.parse_args(["--config", ROOT_CFG, "experiment=gpt2s-moe", "run.steps=3",
                                 "model.dim=32", "--device", "cpu"])
    kwargs, experts = train_cli.apply_config_tree(args)
    assert experts == 4 and args.steps == 3 and args.dim == 32 and args.lr == 6e-4
    assert args.model == "gpt2" and args.layers == 4 and args.seqlen == 256
    assert kwargs["warmup_steps"] == 10 and kwargs["weight_decay"] == 0.1
    assert "learning_rate" not in kwargs and "checkpoint_dir" not in kwargs
    # The mesh keys reach the Trainer (without a mesh they change nothing,
    # as in JAX); run.data_parallel without a process group or torchrun's
    # environment raises.
    tiny = ["model.dim=16", "model.num_layers=1", "model.num_heads=1", "model.vocab=32",
            "run.steps=1", "run.seqlen=8", "run.batch_size=1", "--device", "cpu"]
    for override, field, value in (("trainer.shard_opt_state=true", "shard_opt_state", True),
                                   ("trainer.grad_comm_dtype=bfloat16", "grad_comm_dtype",
                                    "bfloat16")):
        trainer = train_cli.run(["--config", ROOT_CFG, override, *tiny])
        assert getattr(trainer.cfg, field) == value and trainer.world == 1
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="no process group"):
        train_cli.run(["--config", ROOT_CFG, "run.data_parallel=true", *tiny])
    with pytest.raises(SystemExit):
        train_cli.run(["model.dim=16", "--device", "cpu"])  # overrides need --config


def test_config_tree_module_imports_no_yaml():
    source = (REPO / "liteattention_torch" / "training" / "config_tree.py").read_text()
    assert "import yaml" not in source and "from yaml" not in source
    assert os.path.exists(ROOT_CFG)
