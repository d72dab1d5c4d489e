"""The in-repo YAML reader/writer (config/yaml_io.py) against PyYAML."""

import glob
import math
import os

import pytest

from nerf_replication_tpu.config import yaml_io

yaml = pytest.importorskip("yaml")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))


def test_every_config_is_covered():
    assert len(CONFIGS) == 19


@pytest.mark.parametrize("path", CONFIGS)
def test_config_loads_as_pyyaml_loads_it(path):
    with open(os.path.join(ROOT, path)) as f:
        text = f.read()
    ours = yaml_io.safe_load(text)
    assert ours == yaml.safe_load(text)
    # and the writer's text reads back the same in both readers
    dumped = yaml_io.safe_dump(ours)
    assert yaml_io.safe_load(dumped) == ours
    assert yaml.safe_load(dumped) == ours


# CLI ``opts`` values go through the same scalar resolution
@pytest.mark.parametrize("text", [
    "1e-3", "5e-3", "0.02", "1.", "20", "-4", "0x1F", "017", "True",
    "false", "yes", "off", "~", "null", "", "[1,2]", "{a: 1, b: [x, y]}",
    "'quoted # text'", '"tab\\there"', "lego", "1_000", ".inf", "2.5e+3",
])
def test_cli_scalar_like_pyyaml(text):
    ours, theirs = yaml_io.safe_load(text), yaml.safe_load(text)
    if isinstance(theirs, float) and math.isnan(theirs):
        assert math.isnan(ours)
    else:
        assert ours == theirs and type(ours) is type(theirs)


def test_yaml11_quirks():
    """PyYAML (YAML 1.1) reads 5e-3 as a string and 1. as a float."""
    assert yaml_io.safe_load("lr: 5e-3\nr: 1.") == {"lr": "5e-3", "r": 1.0}


def test_save_trained_config_round_trip(tmp_path):
    from nerf_replication_tpu.config import make_cfg, parse_args
    from nerf_replication_tpu.utils.ckpt_utils import save_trained_config

    cfg = make_cfg(parse_args([
        "--cfg_file", os.path.join(ROOT, "configs/nerf/hard_ngp.yaml"),
        "train.lr", "1e-3", "exp_name", "'trip: #1'"]))
    cfg.trained_config_dir = str(tmp_path)
    save_trained_config(cfg)
    with open(tmp_path / "config.yaml") as f:
        text = f.read()
    assert yaml_io.safe_load(text) == cfg.to_dict()
    assert yaml.safe_load(text) == cfg.to_dict()


def test_refuses_unsupported_constructs():
    for text in ("a: &x 1\nb: *x", "a: !!str 1", "a: |\n  text"):
        with pytest.raises(ValueError):
            yaml_io.safe_load(text)
