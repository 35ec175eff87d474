"""Structured snapshot / resume (counterpart of
`slam1_tpu/utils/checkpoint.py`).

Versioned npz snapshots of whole state trees: nested tuples
(NamedTuples) whose leaves are tensors or host integers. The file holds
one array per leaf, `leaf_<i>` in depth-first order, and a JSON header
(`__treedef__`: version, leaf count, caller's meta) as a uint8 array:
the reference's layout, with this package's own leaf order.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from slam1_tpu_torch.utils.tree import flatten, unflatten

SCHEMA_VERSION = 1


def _header(data) -> dict:
    return json.loads(bytes(data["__treedef__"]).decode())


def save(path: str, tree: Any, meta: dict | None = None) -> None:
    leaves = flatten(tree)
    arrays = {f"leaf_{i}": (x.detach().cpu().numpy()
                            if isinstance(x, torch.Tensor) else np.asarray(x))
              for i, x in enumerate(leaves)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path, __treedef__=np.frombuffer(
            json.dumps({"version": SCHEMA_VERSION, "n_leaves": len(leaves),
                        "meta": meta or {}}).encode(), dtype=np.uint8),
        **arrays)


def load(path: str, like: Any) -> Any:
    """Restore into the structure of `like`: each tensor leaf lands on
    the device of `like`'s leaf, each host integer comes back as one. A
    file whose leaf count, or a leaf's shape or dtype, differs from
    `like`'s is rejected."""
    with np.load(path) as data:
        header = _header(data)
        if header["version"] != SCHEMA_VERSION:
            raise ValueError(f"checkpoint schema {header['version']} != "
                             f"{SCHEMA_VERSION}")
        leaves_like = flatten(like)
        n = header["n_leaves"]
        if n != len(leaves_like):
            raise ValueError(
                f"leaf count mismatch: {n} vs {len(leaves_like)}")
        leaves = []
        for i, ref in enumerate(leaves_like):
            a = data[f"leaf_{i}"]
            if not isinstance(ref, torch.Tensor):
                leaves.append(type(ref)(a))
                continue
            t = torch.from_numpy(a)
            if t.shape != ref.shape or t.dtype != ref.dtype:
                raise ValueError(
                    f"leaf {i}: {tuple(t.shape)} {t.dtype} in the file vs "
                    f"{tuple(ref.shape)} {ref.dtype} expected")
            leaves.append(t.to(ref.device))
    return unflatten(like, iter(leaves))


def load_meta(path: str) -> dict:
    with np.load(path) as data:
        return _header(data)["meta"]
