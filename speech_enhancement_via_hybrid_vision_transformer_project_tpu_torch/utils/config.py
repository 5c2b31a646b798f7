"""Config files (JAX ``utils/config.py``) without ``yaml``.

The three YAML files of ``config/`` (data, model, train) are merged in that
order. The card's machine has no YAML library, so ``parse_yaml`` reads the
subset those files use: nested maps by two-space indentation, scalars
(strings plain or quoted, ints, floats, booleans, null), inline lists
``[a, b]`` of scalars, and ``#`` comments. Scalars resolve as YAML 1.1 does
in ``yaml.safe_load`` (a float needs a dot, ``1e-8`` stays a string; ``yes``
and ``on`` are true). Anything else raises ``ValueError``.
"""

from __future__ import annotations

import copy
import json
import re
from pathlib import Path
from typing import Any, Dict, List

CONFIG_FILES = ("data_config.yaml", "model_config.yaml", "train_config.yaml")

_INT = re.compile(r"^[-+]?[0-9]+$")
_FLOAT = re.compile(r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_BOOLS = {"true": True, "yes": True, "on": True, "false": False, "no": False, "off": False}


def _strip_comment(line: str) -> str:
    """``line`` without a ``#`` comment (one at its start or after a
    space, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str) -> Any:
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        try:  # YAML's double-quoted escapes include JSON's
            return json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"unsupported YAML scalar {text!r}") from e
    if text[:1] in "\"'[]{}&*!|>%@`" or text.startswith("- "):
        raise ValueError(f"unsupported YAML scalar {text!r}")
    low = text.lower()
    if low in ("null", "~"):
        return None
    if low in _BOOLS:
        return _BOOLS[low]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    if low in (".inf", "+.inf"):
        return float("inf")
    if low == "-.inf":
        return float("-inf")
    return text


def _value(text: str) -> Any:
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"unsupported YAML list {text!r}")
        inner = text[1:-1].strip()
        return [_scalar(item.strip()) for item in inner.split(",")] if inner else []
    return _scalar(text)


def parse_yaml(text: str) -> Dict[str, Any]:
    """The mapping a YAML document of the supported subset holds ({} when
    it holds nothing)."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        body = line.lstrip(" ")
        if body.startswith("\t") or body.startswith("- ") or body == "-":
            raise ValueError(f"unsupported YAML line {raw!r}")
        lines.append((len(line) - len(body), body))
    root: Dict[str, Any] = {}
    stack: List[tuple[int, Dict[str, Any]]] = [(-1, root)]
    for i, (indent, body) in enumerate(lines):
        while indent <= stack[-1][0]:
            stack.pop()
        key, sep, rest = body.partition(":")
        if not sep or (rest and not rest.startswith(" ")) or not key.strip():
            raise ValueError(f"unsupported YAML line {body!r}")
        key, rest = _scalar(key.strip()), rest.strip()
        parent = stack[-1][1]
        if rest:
            parent[key] = _value(rest)
        elif i + 1 < len(lines) and lines[i + 1][0] > indent:
            parent[key] = {}
            stack.append((indent, parent[key]))
        else:
            parent[key] = None
    return root


def dump_yaml(config: Dict[str, Any], indent: int = 0) -> str:
    """``config`` in the subset ``parse_yaml`` reads (and ``yaml.safe_load``):
    nested maps, scalars and inline lists of scalars."""

    def scalar(v: Any) -> str:
        if isinstance(v, float):
            s = repr(v)  # YAML 1.1 reads a float only with a dot: 1e-08 -> 1.0e-08
            return s.replace("e", ".0e") if "e" in s and "." not in s else s
        return json.dumps(v)

    lines = []
    for k, v in config.items():
        head = "  " * indent + f"{k}:"
        if isinstance(v, dict):
            lines.append(head)
            if v:
                lines.append(dump_yaml(v, indent + 1))
        elif isinstance(v, (list, tuple)):
            lines.append(f"{head} [{', '.join(scalar(x) for x in v)}]")
        else:
            lines.append(f"{head} {scalar(v)}")
    return "\n".join(lines)


def load_config(path: str | Path) -> Dict[str, Any]:
    """One YAML file as a dict."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Config file not found: {path}")
    return parse_yaml(path.read_text())


def save_config(config: Dict[str, Any], path: str | Path) -> None:
    """Write ``config`` as YAML (``dump_yaml``), making the parent directory."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(dump_yaml(config) + "\n")


def merge_configs(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive dict merge; override wins on leaves."""
    out = copy.deepcopy(base)
    for k, v in (override or {}).items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_configs(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_all_configs(config_dir: str | Path = "config") -> Dict[str, Any]:
    """Load and merge the data, model and train configs, in that order."""
    config_dir = Path(config_dir)
    merged: Dict[str, Any] = {}
    for name in CONFIG_FILES:
        p = config_dir / name
        if p.exists():
            merged = merge_configs(merged, load_config(p))
    return merged


def get_config_value(config: Dict[str, Any], path: str, default: Any = None) -> Any:
    """Dot-path getter: ``get_config_value(cfg, 'model.transformer.embed_dim')``."""
    node: Any = config
    for key in path.split("."):
        if not isinstance(node, dict) or key not in node:
            return default
        node = node[key]
    return node


def set_config_value(config: Dict[str, Any], path: str, value: Any) -> None:
    """Dot-path setter, creating intermediate dicts."""
    keys = path.split(".")
    node = config
    for key in keys[:-1]:
        node = node.setdefault(key, {})
        if not isinstance(node, dict):
            raise TypeError(f"Cannot set {path}: {key} is not a mapping")
    node[keys[-1]] = value


def validate_config(config: Dict[str, Any]) -> list[str]:
    """Problems of a merged config, as a list of messages (the JAX
    package's checks)."""
    problems = []
    embed_dim = get_config_value(config, "model.transformer.embed_dim", 512)
    num_heads = get_config_value(config, "model.transformer.num_heads", 8)
    if embed_dim % num_heads != 0:
        problems.append(f"embed_dim ({embed_dim}) not divisible by num_heads ({num_heads})")
    n_fft = get_config_value(config, "audio.n_fft", 512)
    hop = get_config_value(config, "audio.hop_length", 128)
    win = get_config_value(config, "audio.win_length", n_fft)
    if win > n_fft:
        problems.append(f"win_length ({win}) > n_fft ({n_fft})")
    if hop <= 0 or n_fft <= 0:
        problems.append("n_fft and hop_length must be positive")
    n_bins = get_config_value(config, "spectrogram.n_freq_bins", None)
    if n_bins is not None and n_bins != n_fft // 2 + 1:
        problems.append(f"spectrogram.n_freq_bins ({n_bins}) != n_fft//2+1 ({n_fft // 2 + 1})")
    if get_config_value(config, "training.batch_size", 16) <= 0:
        problems.append("training.batch_size must be positive")
    if get_config_value(config, "training.optimizer.lr", 1e-4) <= 0:
        problems.append("training.optimizer.lr must be positive")
    split = get_config_value(config, "data.train_val_split", 0.9)
    if not (0.0 < split < 1.0):
        problems.append("data.train_val_split must be in (0, 1)")
    return problems


def print_config(config: Dict[str, Any]) -> str:
    """Print ``config`` as indented JSON and return the text."""
    text = json.dumps(config, indent=2, default=str)
    print(text)
    return text
