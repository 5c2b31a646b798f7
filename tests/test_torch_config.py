"""The port's config reader (no ``yaml`` on the card's machine) against
``yaml.safe_load`` and the JAX package's ``utils/config.py``."""

from pathlib import Path

import pytest
import yaml

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.utils import config as J
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils import config as C

CONFIG = Path(__file__).resolve().parent.parent / "config"


@pytest.mark.parametrize("name", C.CONFIG_FILES)
def test_shipped_files_read_as_yaml_safe_load(name):
    text = (CONFIG / name).read_text()
    assert C.parse_yaml(text) == yaml.safe_load(text)


def test_merged_config_matches_jax():
    assert C.load_all_configs(CONFIG) == J.load_all_configs(CONFIG)


@pytest.mark.parametrize("text", [
    "a: 1\nb:\n  c: [1, 2.5, x, 'q r', true]\n  d: ~\n  e: 1.0e-8\n  f: 1e-8\n  g: \"#no\"  # yes\n",
    "top:\n  mid:\n    low: -3\n  other: .5\nnext: off\nnone:\n",
    "s: plain words here\nt: 'it''s'\nu: []\nv: \"a \\\"b\\\" c\"\n",
])
def test_subset_matches_yaml_safe_load(text):
    assert C.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["- a\n- b\n", "a: {b: 1}\n", "a: |\n  text\n", "a: &x 1\n"])
def test_unsupported_yaml_raises(text):
    with pytest.raises(ValueError, match="unsupported YAML"):
        C.parse_yaml(text)


def test_get_set_merge_validate_match_jax():
    base = {"model": {"transformer": {"embed_dim": 512, "num_heads": 8}}, "x": 1}
    over = {"model": {"transformer": {"num_heads": 6}}, "y": [1, 2]}
    assert C.merge_configs(base, over) == J.merge_configs(base, over)
    ours, ref = C.merge_configs(base, over), J.merge_configs(base, over)
    for cfg_mod, cfg in ((C, ours), (J, ref)):
        cfg_mod.set_config_value(cfg, "training.optimizer.lr", -1.0)
        cfg_mod.set_config_value(cfg, "audio.win_length", 1024)
        cfg_mod.set_config_value(cfg, "data.train_val_split", 1.5)
    assert ours == ref
    assert C.get_config_value(ours, "model.transformer.num_heads") == 6
    assert C.get_config_value(ours, "model.nothing.here", "d") == "d"
    assert C.validate_config(ours) == J.validate_config(ref) and len(C.validate_config(ours)) == 4
    assert C.validate_config(C.load_all_configs(CONFIG)) == []


def test_dump_yaml_round_trips():
    config = C.load_all_configs(CONFIG)
    C.set_config_value(config, "training.extra", {"tiny": 1e-8, "text": 'say "hi"', "none": None})
    text = C.dump_yaml(config)
    assert C.parse_yaml(text) == config == yaml.safe_load(text)
