"""Checkpoints in the JAX package's format: read, and written by training.

A checkpoint directory holds ``state.msgpack`` (flax ``serialization``:
nested msgpack maps whose array leaves are msgpack ext type 1, packing
``(shape, dtype name, raw C-order bytes)``) and ``meta.json``. The decoder
and encoder here are self-contained, so neither ``flax`` nor ``msgpack`` is
needed.

``flax_to_state_dict`` maps the JAX package's variables onto the port's
``state_dict`` names and layouts:

* conv kernels ``[kh, kw, in, out]`` -> ``[out, in, kh, kw]``;
* Dense kernels ``[in, out]`` -> ``[out, in]``;
* BatchNorm ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` ->
  ``weight``/``bias``/``running_mean``/``running_var``;
* ``attn/Dense_0`` -> ``attn.qkv``, ``attn/Dense_1`` -> ``attn.proj``,
  ``mlp/Dense_0|1`` -> ``mlp.fc1|fc2``, ``block_i`` -> ``blocks.i``; the
  linear-attention branch keeps its names (``lin_attn_i``, ``lin_mlp_i``,
  ``lin_norm1_i``, ``lin_norm2_i``), with the same ``Dense`` renames.

``state_dict_to_flax`` is its inverse. ``save_checkpoint`` writes the
port's training state: ``params`` and ``batch_stats`` in the flax tree, so
that the JAX package's ``load_model_weights`` and this module's reader both
load them, plus ``step`` and ``port_opt_state`` (the port's optimizer, which
only the port resumes from); ``meta.json`` carries the JAX keys (``epoch``,
``global_step``, ``best_val_loss``, ``config``, ``format``).
``optax_state_to_port`` reads the optax state of a checkpoint that the JAX
``Trainer`` wrote (``opt_state``) into the port optimizer's state.
"""

from __future__ import annotations

import json
import re
import struct
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

# ---------------------------------------------------------------------------
# msgpack decoder (the subset flax writes)
# ---------------------------------------------------------------------------

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _decode(r: _Reader) -> Any:
    b = r.unpack(">B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _decode_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_decode(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return bytes(r.take(b & 0x1F)).decode("utf-8")
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
            0xCA: ">f", 0xCB: ">d"}
    if b in ints:
        return r.unpack(ints[b])
    sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",   # bin
             0xD9: ">B", 0xDA: ">H", 0xDB: ">I",   # str
             0xDC: ">H", 0xDD: ">I",               # array
             0xDE: ">H", 0xDF: ">I",               # map
             0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}   # ext
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixext:
        return _decode_ext(r.unpack(">b"), bytes(r.take(fixext[b])))
    if b not in sized:
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
    n = r.unpack(sized[b])
    if b in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(n))
    if b in (0xD9, 0xDA, 0xDB):
        return bytes(r.take(n)).decode("utf-8")
    if b in (0xDC, 0xDD):
        return [_decode(r) for _ in range(n)]
    if b in (0xDE, 0xDF):
        return _decode_map(r, n)
    return _decode_ext(r.unpack(">b"), bytes(r.take(n)))


def _decode_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _decode(r)
        out[k] = _decode(r)
    return out


def _decode_ext(code: int, payload: bytes):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, dtype, raw = msgpack_unpackb(payload)
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported by this reader")
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
    return arr[()] if code == _EXT_NPSCALAR else arr


def msgpack_unpackb(data: bytes) -> Any:
    """Decode one msgpack object (maps, arrays, scalars, str/bin and the
    flax ndarray/scalar ext types)."""
    r = _Reader(data)
    out = _decode(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after msgpack object")
    return out


def msgpack_restore(data: bytes) -> Dict:
    """Nested dict of numpy arrays from flax ``msgpack_serialize`` bytes."""
    tree = msgpack_unpackb(data)
    if not isinstance(tree, dict):
        raise ValueError("checkpoint root is not a map")
    return tree


# ---------------------------------------------------------------------------
# flax variables -> port state_dict
# ---------------------------------------------------------------------------

_MODULE_RENAMES = (
    (re.compile(r"^encoder_(\d+)$"), r"encoder.\1"),
    (re.compile(r"^decoder_(\d+)$"), r"decoder.\1"),
    (re.compile(r"^skip_proj_(\d+)$"), r"skip_proj.\1"),
    (re.compile(r"^block_(\d+)$"), r"blocks.\1"),
    (re.compile(r"^Conv_0$"), "conv"),
    (re.compile(r"^BatchNorm_0$"), "bn"),
)
_LEAF_RENAMES = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _is(parent: Optional[str], kind: str) -> bool:
    """``parent`` is an ``attn``/``mlp`` module, standard or linear-branch."""
    return parent is not None and (parent == kind or parent.startswith(f"lin_{kind}_"))


def _torch_name(path: tuple) -> str:
    parts = []
    for i, p in enumerate(path[:-1]):
        parent = path[i - 1] if i else None
        if _is(parent, "attn") and p in ("Dense_0", "Dense_1"):
            p = {"Dense_0": "qkv", "Dense_1": "proj"}[p]
        elif _is(parent, "mlp") and p in ("Dense_0", "Dense_1"):
            p = {"Dense_0": "fc1", "Dense_1": "fc2"}[p]
        elif parent == "patch_embed" and p == "Conv_0":
            p = "proj"
        else:
            for pat, rep in _MODULE_RENAMES:
                if pat.match(p):
                    p = pat.sub(rep, p)
                    break
        parts.append(p)
    leaf = path[-1]
    parts.append("weight" if leaf == "kernel" else _LEAF_RENAMES.get(leaf, leaf))
    return ".".join(parts)


def _leaves(tree: Dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# ---------------------------------------------------------------------------
# msgpack encoder (the subset flax writes)
# ---------------------------------------------------------------------------


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out += b"\xc0"
    elif obj is True or obj is False:
        out += b"\xc3" if obj else b"\xc2"
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F:
            out += struct.pack(">B", obj)
        elif -32 <= obj < 0:
            out += struct.pack(">b", obj)
        elif obj > 0:
            out += b"\xcf" + struct.pack(">Q", obj)
        else:
            out += b"\xd3" + struct.pack(">q", obj)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += (struct.pack(">B", 0xA0 | len(raw)) if len(raw) < 32
                else b"\xdb" + struct.pack(">I", len(raw))) + raw
    elif isinstance(obj, bytes):
        out += b"\xc6" + struct.pack(">I", len(obj)) + obj
    elif isinstance(obj, (list, tuple)):
        out += b"\xdd" + struct.pack(">I", len(obj))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out += b"\xdf" + struct.pack(">I", len(obj))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack map keys must be str, got {type(k)}")
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)  # (np.ascontiguousarray would make a 0-d array 1-d)
        payload = msgpack_packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))
        code = _EXT_NPSCALAR if isinstance(obj, np.generic) else _EXT_NDARRAY
        out += b"\xc9" + struct.pack(">I", len(payload)) + struct.pack(">b", code) + payload
    else:
        raise TypeError(f"cannot msgpack {type(obj)}")


def msgpack_packb(obj: Any) -> bytes:
    """Encode maps (str keys), lists, scalars, str/bin and numpy arrays (the
    flax ndarray/scalar ext types), readable by flax and ``msgpack_unpackb``."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def flax_to_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{"params": ..., "batch_stats": ...}`` (nested
    numpy dicts) as the port's ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(collection, {})):
            arr = np.asarray(arr)
            if path[-1] == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # [kh,kw,in,out] -> [out,in,kh,kw]
            elif path[-1] == "kernel" and arr.ndim == 2:
                arr = arr.T  # Dense [in,out] -> Linear [out,in]
            out[_torch_name(path)] = torch.tensor(arr)  # a writable copy
    return out


_FLAX_MODULES = {"conv": "Conv_0", "bn": "BatchNorm_0", "qkv": "Dense_0",
                 "fc1": "Dense_0", "fc2": "Dense_1"}
_FLAX_INDEXED = {"encoder": "encoder_", "decoder": "decoder_", "skip_proj": "skip_proj_",
                 "blocks": "block_"}


def _flax_path(name: str, ndim: int) -> tuple[str, tuple]:
    """(collection, flax path) of a port ``state_dict`` name."""
    parts = name.split(".")
    path = []
    i = 0
    while i < len(parts) - 1:
        p = parts[i]
        if p in _FLAX_INDEXED and i + 1 < len(parts) - 1 and parts[i + 1].isdigit():
            path.append(_FLAX_INDEXED[p] + parts[i + 1])
            i += 2
            continue
        if p == "proj":
            p = "Dense_1" if path and _is(path[-1], "attn") else "Conv_0"
        path.append(_FLAX_MODULES.get(p, p))
        i += 1
    leaf = parts[-1]
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", (*path, leaf[len("running_"):])
    if leaf == "weight":
        leaf = "kernel" if ndim in (2, 4) else "scale"
    return "params", (*path, leaf)


def state_dict_to_flax(sd: Dict[str, torch.Tensor]) -> Dict:
    """The port's ``state_dict`` as the JAX package's ``{"params": ...,
    "batch_stats": ...}`` of nested numpy dicts (inverse of
    ``flax_to_state_dict``)."""
    out: Dict = {"params": {}, "batch_stats": {}}
    for name, t in sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        arr = t.detach().cpu().numpy()
        collection, path = _flax_path(name, arr.ndim if name.endswith("weight") else 0)
        if path[-1] == "kernel":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        node = out[collection]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return out


def optax_state_to_port(opt_state: Dict, names: Sequence[str], name: str = "adamw") -> Dict:
    """The JAX trainer's optax state, as a checkpoint stores it, in the form
    of the port ``Optimizer.load_state_dict``. ``names``: the port
    parameters' ``state_dict`` names in the optimizer's order.

    Layout (flax state dicts: tuple members under ``"0"``, ``"1"``, ...,
    NamedTuple fields by name): optional ``MultiSteps`` (``mini_step``,
    ``gradient_step``, ``inner_opt_state``, ``acc_grads``) around an
    optional ``chain(clip_by_global_norm, ...)`` tuple whose last member is
    the ``inject_hyperparams`` state (``count``, ``hyperparams`` with
    ``learning_rate``, ``inner_state``); ``inner_state["0"]`` is Adam's
    ``(count, mu, nu)`` or SGD's ``trace``. Moments and accumulated
    gradients are parameter trees, transposed as the weights are."""
    state: Dict = {"name": name, "mini_step": 0}
    node = opt_state
    if "inner_opt_state" in node:  # MultiSteps
        state["mini_step"] = int(np.asarray(node["mini_step"]))
        state["acc"] = _param_list(node["acc_grads"], names)
        node = node["inner_opt_state"]
    if "hyperparams" not in node and str(len(node) - 1) in node:
        node = node[str(len(node) - 1)]  # chain(clip, optimizer): the optimizer is last
    if "hyperparams" not in node:
        raise ValueError("no inject_hyperparams state in the optax state")
    state["lr"] = float(np.asarray(node["hyperparams"]["learning_rate"]))
    inner = node["inner_state"].get("0", {})
    if name in ("adam", "adamw"):
        if "mu" not in inner:
            raise ValueError(f"optax state holds no Adam moments for optimizer {name!r}")
        state["count"] = int(np.asarray(inner["count"]))
        state["mu"] = _param_list(inner["mu"], names)
        state["nu"] = _param_list(inner["nu"], names)
    else:
        # SGD counts no steps (the port's count matters only to Adam)
        state["count"] = int(np.asarray(node["count"]))
        if "trace" in inner:
            state["trace"] = _param_list(inner["trace"], names)
    return state


def _param_list(tree: Dict, names: Sequence[str]) -> list:
    """A flax parameter tree as tensors in the order of ``names``."""
    sd = flax_to_state_dict({"params": tree})
    missing = [n for n in names if n not in sd]
    if missing or len(sd) != len(names):
        raise KeyError(f"optax state does not match the parameters: missing {missing}, "
                       f"unexpected {sorted(set(sd) - set(names))}")
    return [sd[n] for n in names]


def save_checkpoint(path: str | Path, model: torch.nn.Module, *, step: int = 0,
                    optimizer_state: Optional[Dict] = None, epoch: int = 0,
                    global_step: int = 0, best_val_loss: float = float("inf"),
                    config: Optional[Dict] = None,
                    state_dict: Optional[Dict[str, torch.Tensor]] = None) -> Path:
    """Write ``<path>/state.msgpack`` and ``<path>/meta.json`` (see the
    module docstring). ``optimizer_state``: ``Optimizer.state_dict()``.
    ``state_dict``: the weights to write in place of ``model``'s (a
    tensor-parallel model's gathered ones)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tree = state_dict_to_flax(model.state_dict() if state_dict is None else state_dict)
    tree["step"] = np.asarray(step, np.int32)
    if optimizer_state is not None:
        tree["port_opt_state"] = {
            k: ({str(i): x.detach().cpu().numpy() for i, x in enumerate(v)}
                if isinstance(v, list) else v)
            for k, v in optimizer_state.items()
        }
    (path / "state.msgpack").write_bytes(msgpack_packb(tree))
    meta = {"epoch": int(epoch), "global_step": int(global_step),
            "best_val_loss": float(best_val_loss), "config": config or {},
            "format": "sevit-msgpack-v1"}
    (path / "meta.json").write_text(json.dumps(meta, indent=2, default=str))
    return path


def load_checkpoint(path: str | Path, model: torch.nn.Module,
                    optimizer_name: str = "adamw",
                    shard: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None,
                    ) -> tuple[int, Optional[Dict], Dict]:
    """Load a checkpoint's weights into ``model`` (strict, as
    ``load_model_weights``); returns ``(step, optimizer state or None,
    meta)``. The optimizer state is the port's own, or, from a checkpoint
    of the JAX trainer, its optax state read by ``optax_state_to_port`` for
    the port optimizer ``optimizer_name`` over ``model``'s parameters.
    ``shard(name, tensor)``: the part of a weight, or of a parameter's
    optimizer state, that ``model`` holds (a tensor-parallel rank's)."""
    tree = msgpack_restore((Path(path) / "state.msgpack").read_bytes())
    load_model_weights(path, model, tree=tree, shard=shard)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    opt = tree.get("port_opt_state")
    if opt is not None:
        opt = {k: ([v[str(i)] for i in range(len(v))] if isinstance(v, dict) else v)
               for k, v in opt.items()}
    elif isinstance(tree.get("opt_state"), dict):
        opt = optax_state_to_port(tree["opt_state"], names, optimizer_name)
    if opt is not None and shard is not None:
        opt = {k: ([shard(n, torch.from_numpy(np.array(x))) for n, x in zip(names, v)]
                   if isinstance(v, list) else v) for k, v in opt.items()}
    step = tree.get("step", 0)
    return int(np.asarray(step)), opt, read_meta(path)


def save_model_weights(path: str | Path, model: torch.nn.Module,
                       config: Optional[Dict] = None) -> Path:
    """Weights-only checkpoint for inference (``save_checkpoint`` without a
    training state)."""
    return save_checkpoint(path, model, config=config)


def checkpoint_info(path: str | Path) -> Dict:
    """A checkpoint directory's ``meta.json`` with its ``size_bytes`` (all
    files below it) and ``path``."""
    path = Path(path)
    meta = {}
    if (path / "meta.json").exists():
        meta = json.loads((path / "meta.json").read_text())
    meta["size_bytes"] = sum(f.stat().st_size for f in path.glob("**/*") if f.is_file())
    meta["path"] = str(path)
    return meta


def export_program(path: str | Path, model: torch.nn.Module, example_args: tuple) -> Path:
    """Export ``model``'s forward on ``example_args`` with
    ``torch.export.export`` and write it with ``torch.export.save``; the
    port's counterpart of the JAX package's ``export_stablehlo``.

    The program is the one that runs on the device of the model and its
    inputs. On CUDA it holds the hand-written kernels as single calls,
    ``torch.ops.sevit.stft_mag``, ``attention_fwd`` and ``istft_polar``
    (``ops/kernels.py``); on the CPU the same ops, whose CPU impls are the
    kernels' plain versions. Any other device (meta) raises ``ValueError``.
    The forward is traced without gradients, as an inference program.
    ``torch.export.load`` needs those ops defined before it reads the file:
    ``load_program`` imports the port's ``ops`` and loads."""
    tensors = [*model.parameters(), *model.buffers(),
               *(a for a in example_args if isinstance(a, torch.Tensor))]
    devices = sorted({str(t.device) for t in tensors if t.device.type not in ("cpu", "cuda")})
    if devices:
        raise ValueError(f"export_program: tensors on {devices}; the program computes on "
                         "cpu or cuda")
    with torch.no_grad():  # an inference program: K2 then writes no log-sum-exp
        program = torch.export.export(model, tuple(example_args))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, str(path))
    return path


def load_program(path: str | Path) -> torch.export.ExportedProgram:
    """A program that ``export_program`` wrote, read back with
    ``torch.export.load`` after the ``sevit`` ops are defined; the port's
    counterpart of ``jax.export.deserialize``. ``.module()`` runs it on the
    device it was exported on."""
    from .. import ops  # noqa: F401  (its import defines the sevit ops)

    return torch.export.load(str(path))


def _extract_variables(tree: Dict) -> Dict:
    """Model variables from a weights-only or a full train-state tree."""
    if "params" in tree and "batch_stats" in tree:
        return {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    state = tree.get("state")
    if isinstance(state, dict) and "params" in state:
        return {"params": state["params"], "batch_stats": state.get("batch_stats", {})}
    return tree


def read_variables(path: str | Path) -> Dict:
    """The model variables stored in checkpoint directory ``path``."""
    blob = (Path(path) / "state.msgpack").read_bytes()
    return _extract_variables(msgpack_restore(blob))


def read_meta(path: str | Path) -> Dict:
    """``meta.json`` of a checkpoint directory; {} when missing or unreadable
    (the weights stay loadable)."""
    mp = Path(path) / "meta.json"
    if not mp.exists():
        return {}
    try:
        meta = json.loads(mp.read_text())
    except (json.JSONDecodeError, OSError) as e:
        print(f"warning: unreadable meta.json under {path} ({e})")
        return {}
    return meta if isinstance(meta, dict) else {}


def load_model_weights(path: str | Path, model: torch.nn.Module,
                       tree: Optional[Dict] = None,
                       shard: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None,
                       ) -> torch.nn.Module:
    """Load a checkpoint's weights into ``model`` (strict: every parameter
    and buffer must be present with the right shape). ``tree``: the
    checkpoint's decoded ``state.msgpack``, when already read; ``shard``:
    see ``load_checkpoint``."""
    sd = flax_to_state_dict(read_variables(path) if tree is None else _extract_variables(tree))
    if shard is not None:
        sd = {k: shard(k, v) for k, v in sd.items()}
    own = model.state_dict()
    missing = sorted(set(own) - set(sd) - {k for k in own if k.endswith("num_batches_tracked")})
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(
            f"checkpoint {path} does not match the model: missing {missing}, "
            f"unexpected {unexpected}"
        )
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: checkpoint {tuple(v.shape)} vs model {tuple(own[k].shape)}")
    model.load_state_dict(sd, strict=False)
    return model
