"""Reading PyTorch zip checkpoints without running pickled code (counterpart
of `adaface_tpu/interop/torch_pickle.py`).

An SD v1.x `.ckpt` pickles Lightning objects beside its `state_dict`, and a
reference `embeddings_gs-*.pt` pickles live `nn.Module`s (static embedders,
subject-basis generators); `torch.load(weights_only=True)` refuses both. This
reader unpickles the zip's `data.pkl` with a restricted unpickler:

- tensors rebuild from the archive's storages (`_rebuild_tensor_v2`,
  `_rebuild_parameter`) as CPU tensors of the stored dtype (bf16 included),
  one storage read once and shared by its views;
- containers, numbers, strings and torch dtypes map to themselves;
- every other global (a module class, an omegaconf or argparse object, a
  callback) becomes an inert `TorchObjectStub` that keeps the pickled state
  (`_parameters`, `_buffers`, `_modules`, attributes) as data; calling a
  stub records its arguments and runs nothing.

`walk_stub_tree` flattens such a tree into dotted name -> tensor, as
`state_dict()` would have named them. `load_sd_state_dict` reads either a
torch zip (`.ckpt`, `.pt`, `.bin`; a Lightning `state_dict` wrapper is
unwrapped) or a `.safetensors` file (through `checkpoint_io`).
"""

from __future__ import annotations

import collections
import io
import pickle
import zipfile
from typing import Any, Dict

import numpy as np
import torch

from adaface_tpu_torch.interop.checkpoint_io import load_safetensors

# storage class name in the pickle -> element dtype
_STORAGE_DTYPES = {
    "FloatStorage": torch.float32, "DoubleStorage": torch.float64,
    "HalfStorage": torch.float16, "BFloat16Storage": torch.bfloat16,
    "LongStorage": torch.int64, "IntStorage": torch.int32, "ShortStorage": torch.int16,
    "CharStorage": torch.int8, "ByteStorage": torch.uint8, "BoolStorage": torch.bool,
}
_DTYPE_NAMES = {"float32", "float64", "float16", "bfloat16", "int64", "int32", "int16",
                "int8", "uint8", "bool", "float", "double", "half", "long", "int"}


class TorchObjectStub:
    """Inert stand-in for a pickled object of a class outside the allowlist.
    Its `__dict__` holds `_stub_qualname`, `_stub_args` (the constructor
    arguments the pickle recorded, if any) and the pickled state."""

    def __init__(self, qualname: str):
        self.__dict__["_stub_qualname"] = qualname
        self.__dict__["_stub_args"] = None

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif (isinstance(state, tuple) and len(state) == 2
              and isinstance(state[0], (dict, type(None)))):
            # (state, slotstate), as object.__reduce_ex__ writes for slots
            for part in state:
                if part:
                    self.__dict__.update(part)
        else:
            self.__dict__["_stub_state"] = state

    def __call__(self, *args, **kwargs):  # REDUCE on a stub: record, don't run
        rec = TorchObjectStub(self._stub_qualname + "()")
        rec.__dict__["_stub_args"] = (args, kwargs)
        return rec

    def __repr__(self):
        return f"<stub {self.__dict__.get('_stub_qualname')}>"


def _stub_factory(qualname: str):
    class _Factory(TorchObjectStub):
        def __new__(cls, *a, **k):
            obj = TorchObjectStub(qualname)
            if a or k:
                obj.__dict__["_stub_args"] = (a, k)
            return obj

    _Factory.__name__ = qualname.rsplit(".", 1)[-1]
    return _Factory


class _Storage:
    """One storage blob of the archive, read when its first tensor is rebuilt."""

    def __init__(self, zf: zipfile.ZipFile, name: str, dtype: torch.dtype):
        self.zf, self.name, self.dtype = zf, name, dtype
        self._flat = None

    def flat(self) -> torch.Tensor:
        if self._flat is None:
            info = self.zf.getinfo(self.name)
            buf = torch.empty(info.file_size, dtype=torch.uint8)
            with self.zf.open(info) as f:
                view, got = memoryview(buf.numpy()), 0
                while got < info.file_size:
                    n = f.readinto(view[got:])
                    if not n:
                        raise ValueError(f"{self.name} is truncated")
                    got += n
            self._flat = buf.view(self.dtype)
        return self._flat


def _rebuild_tensor_v2(storage, storage_offset, size, stride, requires_grad=False,
                       backward_hooks=None, metadata=None):
    if not isinstance(storage, _Storage):
        raise pickle.UnpicklingError(f"unexpected storage {storage!r}")
    return storage.flat().as_strided(tuple(size), tuple(stride), storage_offset)


def _rebuild_parameter(data, requires_grad=False, backward_hooks=None, state=None):
    return data


def _reconstructor(cls, base, state):
    """copyreg._reconstructor (pickle protocols 0 and 1) for a stub class."""
    if isinstance(cls, type) and issubclass(cls, TorchObjectStub):
        return cls()
    raise pickle.UnpicklingError(f"refusing to reconstruct {cls!r}")


_SAFE = {
    ("collections", "OrderedDict"): collections.OrderedDict,
    ("builtins", "set"): set, ("builtins", "frozenset"): frozenset,
    ("builtins", "list"): list, ("builtins", "dict"): dict, ("builtins", "tuple"): tuple,
    ("builtins", "int"): int, ("builtins", "float"): float, ("builtins", "complex"): complex,
    ("builtins", "str"): str, ("builtins", "bytes"): bytes, ("builtins", "bool"): bool,
    ("torch._utils", "_rebuild_tensor_v2"): _rebuild_tensor_v2,
    ("torch._utils", "_rebuild_parameter"): _rebuild_parameter,
    ("torch._utils", "_rebuild_parameter_with_state"): _rebuild_parameter,
    ("torch", "Size"): torch.Size,
    ("copyreg", "_reconstructor"): _reconstructor,
    ("numpy", "dtype"): np.dtype,
    ("numpy.core.multiarray", "scalar"): lambda dt, b: np.frombuffer(b, dtype=dt)[0],
    ("numpy._core.multiarray", "scalar"): lambda dt, b: np.frombuffer(b, dtype=dt)[0],
    ("_codecs", "encode"): lambda s, enc: s.encode(enc),
}


class _RestrictedUnpickler(pickle.Unpickler):
    def __init__(self, file, zf: zipfile.ZipFile, root: str):
        super().__init__(file)
        self._zf, self._root = zf, root
        self._storages: Dict[str, _Storage] = {}

    def find_class(self, module: str, name: str):
        if (module, name) in _SAFE:
            return _SAFE[(module, name)]
        if module == "torch" and name in _STORAGE_DTYPES:
            return name  # a storage type: only a tag inside persistent ids
        if module == "torch" and name in _DTYPE_NAMES:
            return getattr(torch, name)
        return _stub_factory(f"{module}.{name}")

    def persistent_load(self, pid):
        # ('storage', storage type, key, location, numel)
        if not (isinstance(pid, tuple) and pid and pid[0] == "storage"):
            raise pickle.UnpicklingError(f"unsupported persistent id {pid!r}")
        _, stype, key, _location, _numel = pid
        tname = stype if isinstance(stype, str) else getattr(stype, "__name__", str(stype))
        if tname not in _STORAGE_DTYPES:
            raise pickle.UnpicklingError(f"unknown storage type {tname}")
        if key not in self._storages:
            self._storages[key] = _Storage(self._zf, f"{self._root}/data/{key}",
                                           _STORAGE_DTYPES[tname])
        return self._storages[key]


def load_torch_checkpoint(path: str) -> Any:
    """A torch zip checkpoint as a tree of dicts, lists, CPU tensors and
    `TorchObjectStub`s."""
    with zipfile.ZipFile(path) as zf:
        pkl = [n for n in zf.namelist() if n.endswith("/data.pkl") or n == "data.pkl"]
        if not pkl:
            raise ValueError(f"{path} is not a torch zip checkpoint")
        root = pkl[0][:-len("/data.pkl")] if "/" in pkl[0] else ""
        bo = f"{root}/byteorder"
        if root and bo in zf.namelist() and zf.read(bo).strip() != b"little":
            raise ValueError(f"{path}: big-endian storages are not supported")
        # every tensor reads its storage as it is rebuilt, inside this block
        return _RestrictedUnpickler(io.BytesIO(zf.read(pkl[0])), zf, root).load()


def load_sd_state_dict(path: str) -> Dict[str, Any]:
    """A flat SD-style state dict from a `.safetensors` file or a torch zip
    (`.ckpt` / `.pt` / `.bin`, the Lightning `state_dict` wrapper unwrapped)."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    ckpt = load_torch_checkpoint(path)
    if isinstance(ckpt, dict):
        return ckpt.get("state_dict", ckpt)
    return ckpt


def walk_stub_tree(obj: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Dotted name -> tensor of a loaded tree (modules as stubs included),
    as `state_dict()` would name them: a stub's `_parameters` and
    `_buffers` at its prefix, its `_modules` and other container attributes
    beneath it."""
    flat: Dict[str, torch.Tensor] = {}

    def rec(o, pfx):
        if torch.is_tensor(o):
            flat[pfx.rstrip(".")] = o
        elif isinstance(o, dict):
            for k, v in o.items():
                rec(v, f"{pfx}{k}.")
        elif isinstance(o, (list, tuple)):
            for i, v in enumerate(o):
                rec(v, f"{pfx}{i}.")
        elif isinstance(o, TorchObjectStub):
            d = o.__dict__
            for container in ("_parameters", "_buffers"):
                for k, v in (d.get(container) or {}).items():
                    if torch.is_tensor(v):
                        flat[f"{pfx}{k}"] = v
            for k, v in (d.get("_modules") or {}).items():
                rec(v, f"{pfx}{k}.")
            for k, v in d.items():
                if k.startswith("_stub") or k in ("_parameters", "_buffers", "_modules"):
                    continue
                if torch.is_tensor(v) or isinstance(v, (dict, list, tuple, TorchObjectStub)):
                    rec(v, f"{pfx}{k}.")

    rec(obj, prefix)
    return flat
