"""BTPU — the versioned module and optim-method persistence format,
ported from ``bigdl_tpu/utils/module_format.py``
(``utils/serializer/ModuleSerializer.scala:34``).

- **Wire layout** (``utils/protowire``), the JAX package's: ``b"BTPU"``,
  a format-version varint, then field 1 a header JSON, field 2 a
  structure JSON and one field 3 per tensor (a dtype/shape JSON and the
  raw little-endian bytes).
- **Structure**: JSON that describes the object graph.  Objects are
  recorded by class name and resolved on load against a registry of the
  port's own classes (modules, criterions, optim methods, schedules,
  regularizers), never by unpickling, so loading a file runs no code
  the file names.  A ``torch.nn.Module`` is recorded as its own
  attributes, its children in order, its parameters and its buffers (not
  PyTorch's internal tables), and rebuilt through
  ``torch.nn.Module.__init__``, so a file does not depend on the
  PyTorch version that wrote it.
- **Sharing**: an object visited twice is written once and referenced.
- **Versioning**: an unknown format version or class name is refused
  with a clear error.

Tensors load on the CPU: a ``torch.Tensor`` comes back as one (a
``Parameter`` as a ``Parameter``), a numpy array as a numpy array.
"""

from __future__ import annotations

import base64
import importlib
import json
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.utils import protowire

__all__ = ["dumps", "loads", "SerializationError", "FORMAT_VERSION",
           "MAGIC"]

MAGIC = b"BTPU"
FORMAT_VERSION = 1

#: modules scanned for serializable classes (class name -> class)
_SCAN_MODULES = (
    "bigdl_tpu_torch.nn",
    "bigdl_tpu_torch.nn.module",
    "bigdl_tpu_torch.nn.init",
    "bigdl_tpu_torch.nn.criterion",
    "bigdl_tpu_torch.optim.optim_method",
    "bigdl_tpu_torch.optim.regularizer",
    "bigdl_tpu_torch.models.resnet",
    "bigdl_tpu_torch.models.inception",
    "bigdl_tpu_torch.models.transformer",
)

_DTYPES = ("float32", "float64", "float16", "bfloat16", "int8", "int16",
           "int32", "int64", "uint8", "bool")

#: what every ``torch.nn.Module`` keeps in its ``__dict__``; rebuilt by
#: ``torch.nn.Module.__init__`` on load, never written
_TORCH_KEYS = frozenset(vars(torch.nn.Module()))


class SerializationError(Exception):
    pass


_registry_cache: Optional[Dict[str, type]] = None


def _registry() -> Dict[str, type]:
    global _registry_cache
    if _registry_cache is None:
        _registry_cache = {}
        for modname in _SCAN_MODULES:
            for obj in vars(importlib.import_module(modname)).values():
                if isinstance(obj, type) \
                        and obj.__module__.startswith("bigdl_tpu_torch"):
                    _registry_cache.setdefault(obj.__name__, obj)
    return _registry_cache


def _torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise SerializationError(f"disallowed tensor dtype {name!r}")
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

class _Encoder:
    def __init__(self):
        self.memo: Dict[int, int] = {}
        self.next_id = 0
        self.tensors: List[Tuple[str, Tuple[int, ...], bytes]] = []
        self.tensor_memo: Dict[int, int] = {}
        # id()-keyed memos hold only while the objects stay alive
        self._keepalive: List[Any] = []

    def tensor(self, arr) -> int:
        key = id(arr)
        if key in self.tensor_memo:
            return self.tensor_memo[key]
        self._keepalive.append(arr)
        t = torch.as_tensor(arr).detach().cpu().contiguous()
        name = str(t.dtype)[len("torch."):]
        if name not in _DTYPES:
            raise SerializationError(f"cannot persist dtype {t.dtype}")
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t) \
            .numpy().tobytes()
        idx = len(self.tensors)
        self.tensors.append((name, tuple(t.shape), raw))
        self.tensor_memo[key] = idx
        return idx

    def value(self, v) -> Any:  # noqa: C901 - one dispatch table
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        if isinstance(v, (np.bool_, np.integer)):
            return {"__t__": "npscalar", "dtype": v.dtype.name, "v": int(v)}
        if isinstance(v, np.floating):
            return {"__t__": "npscalar", "dtype": v.dtype.name,
                    "v": float(v)}
        if isinstance(v, bytes):
            return {"__t__": "bytes", "v": base64.b64encode(v).decode()}
        if isinstance(v, (list, tuple, set, frozenset)):
            kind = {list: "list", tuple: "tuple", set: "set",
                    frozenset: "frozenset"}.get(type(v), "list")
            return {"__t__": kind, "v": [self.value(x) for x in v]}
        if isinstance(v, dict):
            return {"__t__": "dict",
                    "v": [[self.value(k), self.value(x)]
                          for k, x in v.items()]}
        if isinstance(v, torch.Tensor):
            return {"__t__": "tensor", "i": self.tensor(v), "torch": True,
                    "param": isinstance(v, torch.nn.Parameter)}
        if isinstance(v, np.ndarray):
            return {"__t__": "tensor", "i": self.tensor(v)}
        if isinstance(v, torch.dtype):
            return {"__t__": "tdtype", "v": str(v)[len("torch."):]}
        if isinstance(v, np.dtype):
            return {"__t__": "dtype", "v": v.name}
        if isinstance(v, type):
            if _registry().get(v.__name__) is v:
                return {"__t__": "class", "c": v.__name__}
            raise SerializationError(f"cannot persist class {v!r}")
        if callable(v) and hasattr(v, "__qualname__") \
                and not isinstance(v, torch.nn.Module) \
                and type(v).__name__ == "function":
            m, q = v.__module__ or "", v.__qualname__
            if m.startswith("bigdl_tpu_torch") and "<" not in q \
                    and "." not in q:
                return {"__t__": "fn", "m": m, "q": q}
            raise SerializationError(
                f"cannot persist callable {q} from {m} (only module-level "
                f"bigdl_tpu_torch functions are serializable)")
        cls = type(v)
        if _registry().get(cls.__name__) is not cls:
            raise SerializationError(
                f"cannot persist {cls.__module__}.{cls.__name__}: not a "
                f"class of the port's registry")
        if id(v) in self.memo:
            return {"__t__": "ref", "id": self.memo[id(v)]}
        oid = self.next_id
        self.next_id += 1
        self.memo[id(v)] = oid
        self._keepalive.append(v)
        if isinstance(v, torch.nn.Module):
            return self._module(v, oid)
        return {"__t__": "obj", "c": cls.__name__, "id": oid,
                "a": {k: self.value(x) for k, x in vars(v).items()}}

    def _module(self, m: torch.nn.Module, oid: int) -> Dict[str, Any]:
        attrs = {k: self.value(x) for k, x in vars(m).items()
                 if k not in _TORCH_KEYS}
        params = [[k, None if p is None else self.value(p)]
                  for k, p in m._parameters.items()]
        buffers = [[k, self.value(b), k not in m._non_persistent_buffers_set]
                   for k, b in m._buffers.items()]
        return {"__t__": "module", "c": type(m).__name__, "id": oid,
                "a": attrs, "training": m.training,
                "m": [[k, self.value(c)] for k, c in m._modules.items()],
                "p": params, "b": buffers}


def dumps(obj, kind: str = "module") -> bytes:
    """``obj`` as BTPU bytes; every tensor is copied to the host now."""
    enc = _Encoder()
    structure = enc.value(obj)
    header = {"format": "bigdl_tpu_torch", "kind": kind,
              "tensors": len(enc.tensors)}
    out = [MAGIC, protowire.write_varint(FORMAT_VERSION),
           protowire.emit_bytes(1, json.dumps(header).encode()),
           protowire.emit_bytes(2, json.dumps(structure).encode())]
    for dtype, shape, raw in enc.tensors:
        meta = json.dumps({"dtype": dtype, "shape": list(shape)}).encode()
        entry = protowire.emit_bytes(1, meta) + protowire.emit_bytes(2, raw)
        out.append(protowire.emit_bytes(3, entry))
    return b"".join(out)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class _Decoder:
    def __init__(self, tensors: List[torch.Tensor]):
        self.tensors = tensors
        self.memo: Dict[int, Any] = {}

    def value(self, v) -> Any:  # noqa: C901
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        if not isinstance(v, dict):
            raise SerializationError(f"malformed structure node {v!r}")
        t = v.get("__t__")
        if t == "npscalar":
            if v["dtype"] not in _DTYPES or v["dtype"] == "bfloat16":
                raise SerializationError(f"disallowed dtype {v['dtype']!r}")
            return np.dtype(v["dtype"]).type(v["v"])
        if t == "bytes":
            return base64.b64decode(v["v"])
        if t in ("list", "tuple", "set", "frozenset"):
            items = [self.value(x) for x in v["v"]]
            return {"list": list, "tuple": tuple, "set": set,
                    "frozenset": frozenset}[t](items)
        if t == "dict":
            return {self.value(k): self.value(x) for k, x in v["v"]}
        if t == "tensor":
            arr = self.tensors[self._index(v["i"])].clone()
            if v.get("param"):
                return torch.nn.Parameter(arr, requires_grad=True)
            return arr if v.get("torch") else arr.numpy()
        if t == "tdtype":
            return _torch_dtype(v["v"])
        if t == "dtype":
            if v["v"] not in _DTYPES or v["v"] == "bfloat16":
                raise SerializationError(f"disallowed dtype {v['v']!r}")
            return np.dtype(v["v"])
        if t == "class":
            return self._resolve(v["c"])
        if t == "fn":
            m = v["m"]
            if not m.startswith("bigdl_tpu_torch"):
                raise SerializationError(f"refusing function module {m!r}")
            fn = getattr(importlib.import_module(m), v["q"], None)
            if fn is None or not callable(fn):
                raise SerializationError(f"unknown function {m}:{v['q']}")
            return fn
        if t == "obj":
            cls = self._resolve(v["c"])
            obj = cls.__new__(cls)
            self.memo[v["id"]] = obj  # before the attributes: cycles
            for k, x in v["a"].items():
                obj.__dict__[k] = self.value(x)
            return obj
        if t == "module":
            return self._module(v)
        if t == "ref":
            if v["id"] not in self.memo:
                raise SerializationError(f"dangling ref {v['id']}")
            return self.memo[v["id"]]
        raise SerializationError(f"unknown structure tag {t!r}")

    def _module(self, v) -> torch.nn.Module:
        cls = self._resolve(v["c"])
        if not issubclass(cls, torch.nn.Module):
            raise SerializationError(f"{v['c']} is not a module")
        m = cls.__new__(cls)
        torch.nn.Module.__init__(m)
        self.memo[v["id"]] = m
        for k, x in v["a"].items():
            m.__dict__[k] = self.value(x)
        m.training = bool(v["training"])
        for k, c in v["m"]:
            child = self.value(c)
            if not isinstance(child, torch.nn.Module):
                raise SerializationError(f"child {k!r} is not a module")
            m._modules[k] = child
        for k, p in v["p"]:
            p = self.value(p)
            if p is not None and not isinstance(p, torch.nn.Parameter):
                p = torch.nn.Parameter(torch.as_tensor(p))
            m._parameters[k] = p
        for k, b, persistent in v["b"]:
            m._buffers[k] = self.value(b)
            if not persistent:
                m._non_persistent_buffers_set.add(k)
        return m

    def _index(self, i) -> int:
        if not isinstance(i, int) or not 0 <= i < len(self.tensors):
            raise SerializationError(f"tensor index {i!r} out of range")
        return i

    @staticmethod
    def _resolve(name: str) -> type:
        cls = _registry().get(name)
        if cls is None:
            raise SerializationError(
                f"unknown class {name!r}: written by a newer version or "
                f"by another program")
        return cls


def loads(blob: bytes, kind: Optional[str] = None):
    if not blob.startswith(MAGIC):
        raise SerializationError("not a BTPU file (bad magic)")
    version, pos = protowire.read_varint(blob, len(MAGIC))
    if version != FORMAT_VERSION:
        raise SerializationError(
            f"unsupported BTPU format version {version} "
            f"(this build reads version {FORMAT_VERSION})")
    header = structure = None
    tensors: List[torch.Tensor] = []
    try:
        for field, wt, val in protowire.fields(blob[pos:]):
            if field == 1 and wt == 2:
                header = json.loads(val.decode())
            elif field == 2 and wt == 2:
                structure = json.loads(val.decode())
            elif field == 3 and wt == 2:
                meta = raw = None
                for f2, w2, v2 in protowire.fields(val):
                    if f2 == 1 and w2 == 2:
                        meta = json.loads(v2.decode())
                    elif f2 == 2 and w2 == 2:
                        raw = v2
                if meta is None or raw is None:
                    raise SerializationError("malformed tensor record")
                dt = _torch_dtype(meta["dtype"])
                shape = tuple(int(s) for s in meta["shape"])
                size = torch.empty((), dtype=dt).element_size()
                n = int(np.prod(shape, dtype=np.int64)) * size
                if len(raw) != n:
                    raise SerializationError(
                        f"tensor byte count {len(raw)} != expected {n}")
                flat = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
                tensors.append(flat.view(dt).reshape(shape) if n
                               else torch.empty(shape, dtype=dt))
    except (IndexError, struct.error, UnicodeDecodeError,
            json.JSONDecodeError) as e:
        raise SerializationError(f"corrupted BTPU file: {e}") from e
    if header is None or structure is None:
        raise SerializationError(
            "corrupted BTPU file: missing header or structure")
    if kind is not None and header.get("kind") != kind:
        raise SerializationError(
            f"expected a {kind!r} file, found {header.get('kind')!r}")
    if header.get("tensors") != len(tensors):
        raise SerializationError("corrupted BTPU file: tensor count mismatch")
    return _Decoder(tensors).value(structure)
