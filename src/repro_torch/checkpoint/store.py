"""Versioned artifact store, ported from ``repro/checkpoint/store.py``,
in its on-disk format, so each side reads what the other writes:

* ``<dir>/step_<n:08d>/arrays.npz`` holds leaf i as ``a<i>``;
  ``manifest.json`` holds ``step``, ``keys`` ("/"-joined leaf paths in the
  reference's flatten order: dict keys sorted), ``dtypes``, ``shapes``,
  ``sha256`` of ``arrays.npz`` and the caller's ``extra``;
* bf16 and f16 leaves are stored upcast to f32 (lossless; npz holds no
  bf16) with their dtype named in the manifest, so a reader needs numpy
  and torch alone;
* atomic: written into ``<dir>/tmp.<step>``, fsynced, renamed;
* the sha256 is verified on restore, and a ``keep``-newest garbage
  collection follows every save.

Trees are nested dicts (lists and tuples too) whose leaves are tensors or
numpy arrays; ``restore_tree`` returns nested dicts of CPU tensors in the
stored dtypes, ``restore(step, like=)`` the structure of ``like`` with each
tensor leaf in its ``like`` leaf's dtype and on its device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                 "float32": torch.float32, "float64": torch.float64,
                 "int8": torch.int8, "uint8": torch.uint8,
                 "int16": torch.int16, "int32": torch.int32,
                 "int64": torch.int64, "bool": torch.bool}


def _flatten(tree: Any, path: Tuple[str, ...] = ()
             ) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], path + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, path + (str(i),)))
        return out
    return [("/".join(path), tree)]


def _to_numpy(v: Any) -> Tuple[np.ndarray, str]:
    """(array npz can hold, the leaf's dtype name)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype in (torch.bfloat16, torch.float16):
            return t.float().numpy(), name
        return t.numpy(), name
    a = np.asarray(v)
    if a.dtype == np.float16 or a.dtype.name == "bfloat16":
        return a.astype(np.float32), a.dtype.name
    return a, a.dtype.name


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> str:
        tmp = os.path.join(self.directory, f"tmp.{step}")
        final = self._dir(step)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = _flatten(tree)
        arrays, dtypes, shapes = {}, [], []
        for i, (_, v) in enumerate(flat):
            a, name = _to_numpy(v)
            arrays[f"a{i}"] = a
            dtypes.append(name)
            shapes.append(list(a.shape))
        shard = os.path.join(tmp, "arrays.npz")
        np.savez(shard, **arrays)
        manifest = {"step": step, "keys": [k for k, _ in flat],
                    "dtypes": dtypes, "shapes": shapes,
                    "sha256": {"arrays.npz": _sha256(shard)},
                    "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)        # atomic publish
        self._gc()
        return final

    def steps(self) -> List[int]:
        """Published steps, oldest first (a directory without a manifest is
        a partial write and is skipped)."""
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def manifest(self, step: int) -> Dict:
        with open(os.path.join(self._dir(step), "manifest.json")) as f:
            return json.load(f)

    def restore_tree(self, step: int, verify: bool = True,
                     prefix: Optional[str] = None
                     ) -> Tuple[Dict[str, Any], Dict]:
        """The saved tree as nested dicts of CPU tensors in their stored
        dtypes, rebuilt from the manifest's "/"-joined keys, and the
        manifest; with ``prefix`` only the leaves under that key (the
        others are not read). Raises IOError when ``arrays.npz`` fails its
        sha256 (over the whole file)."""
        manifest = self.manifest(step)
        apath = os.path.join(self._dir(step), "arrays.npz")
        if verify:
            got, want = _sha256(apath), manifest["sha256"]["arrays.npz"]
            if got != want:
                raise IOError(f"checkpoint corruption at step {step}: "
                              f"sha256 {got} != {want}")
        tree: Dict[str, Any] = {}
        with np.load(apath) as data:
            for i, key in enumerate(manifest["keys"]):
                if prefix is not None and not key.startswith(prefix + "/"):
                    continue
                parts = key.split("/")
                node = tree
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                t = torch.from_numpy(np.array(data[f"a{i}"]))
                node[parts[-1]] = t.to(_TORCH_DTYPES[manifest["dtypes"][i]])
        return tree, manifest

    def restore(self, step: int, like: Any, verify: bool = True) -> Any:
        """The saved tree in the structure of ``like`` (the reference's
        ``restore`` without its shardings): tensor leaves come back in the
        dtype and on the device of ``like``'s, other leaves as stored CPU
        tensors. Raises ValueError when the structures differ."""
        tree, manifest = self.restore_tree(step, verify)
        if [k for k, _ in _flatten(like)] != manifest["keys"]:
            raise ValueError("checkpoint/param-tree structure mismatch")
        return _rebuild(tree, like)

    def restore_subtree(self, step: int, key: str, like: Any,
                        verify: bool = True) -> Any:
        """The saved tree's ``key`` subtree (the ``params`` of a training
        checkpoint) in the structure of ``like``, as ``restore`` returns a
        whole tree. Raises ValueError when the structures or shapes
        differ."""
        tree, manifest = self.restore_tree(step, verify, prefix=key)
        if key not in tree or sorted(k for k, _ in _flatten(tree[key])) != \
                sorted(k for k, _ in _flatten(like)):
            raise ValueError(f"checkpoint step {step}: its {key!r} subtree "
                             f"is not the structure asked for")
        out = _rebuild(tree[key], like)
        for (_, a), (_, b) in zip(_flatten(out), _flatten(like)):
            if isinstance(b, torch.Tensor) and a.shape != b.shape:
                raise ValueError(f"checkpoint step {step}: a {key!r} leaf "
                                 f"of shape {tuple(a.shape)} where "
                                 f"{tuple(b.shape)} was asked for")
        return out

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._dir(s), ignore_errors=True)


def _rebuild(tree: Dict[str, Any], like: Any) -> Any:
    """``like``'s structure filled from ``restore_tree``'s nested dicts:
    tensor leaves in their ``like`` leaf's dtype and on its device."""
    def stored(path):
        node = tree
        for p in "/".join(path).split("/"):
            node = node[p]
        return node

    def rebuild(t, path):
        if isinstance(t, dict):
            return {k: rebuild(v, path + (str(k),)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            items = [rebuild(v, path + (str(i),)) for i, v in enumerate(t)]
            if hasattr(t, "_fields"):           # a NamedTuple
                return type(t)(*items)
            return type(t)(items)
        leaf = stored(path)
        if isinstance(t, torch.Tensor):
            return leaf.to(device=t.device, dtype=t.dtype)
        return leaf

    return rebuild(like, ())
