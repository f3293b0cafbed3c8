"""Parameter checkpoint save/load, in the JAX package's format.

A checkpoint is one ``.npz`` of the tree's leaves under ``::``-joined
paths and a ``.config.json`` sidecar holding ``dataclasses.asdict`` of the
``LlamaConfig``, its ``"dtype"`` as the bare name (``"bfloat16"``), and
``"_array_dtypes"``: the real dtype of every leaf numpy cannot hold
(bfloat16, stored as a same-width integer view). A file that either
package writes loads in the other with every leaf equal; quantized trees
(``{"q", "scale"}``, int4's ``q4`` and its zero-element ``q4_pad``) keep
their dtypes.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..models.llama import LlamaConfig

_SEP = "::"
# a leaf numpy cannot hold is stored as an unsigned integer view of its
# width (as the JAX package stores it) and carried through torch as a
# signed or unsigned integer view that torch can build from numpy
_STORED = {1: np.uint8, 2: np.uint16}
_CARRY = {1: (np.uint8, torch.uint8), 2: (np.int16, torch.int16)}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _flatten(tree, prefix="") -> Dict[str, torch.Tensor]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    else:
        out[prefix[: -len(_SEP)]] = tree
    return out


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for path, leaf in flat.items():
        node = tree
        parts = path.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def _norm_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_params(path: str, cfg: LlamaConfig, params) -> None:
    """Write ``params`` (tensors on any device) and ``cfg`` to ``path``
    (``.npz`` appended if missing) and its ``.config.json`` sidecar."""
    path = _norm_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    dtypes, store = {}, {}
    for k, t in _flatten(params).items():
        t = t.detach().cpu()
        try:
            store[k] = t.numpy()
        except TypeError:                    # bfloat16 and other dtypes
            size = t.element_size()          # numpy lacks
            dtypes[k] = _dtype_name(t.dtype)
            store[k] = t.view(_CARRY[size][1]).numpy().view(_STORED[size])
    np.savez(path, **store)
    cfg_dict = dataclasses.asdict(cfg)
    cfg_dict["dtype"] = _dtype_name(cfg.dtype)
    cfg_dict["_array_dtypes"] = dtypes
    with open(path + ".config.json", "w") as f:
        json.dump(cfg_dict, f, indent=2)


def load_params(path: str, device="cuda") -> Tuple[LlamaConfig, Dict]:
    """(cfg, params) of a checkpoint, the leaves placed on ``device``."""
    path = _norm_path(path)
    with open(path + ".config.json") as f:
        cfg_dict = json.load(f)
    dtypes = cfg_dict.pop("_array_dtypes", {})
    cfg_dict["dtype"] = getattr(torch, cfg_dict["dtype"])
    if cfg_dict.get("rope_scaling") is not None:
        # ("llama3"/"yarn", (params...)) nests a tuple that json round-trips
        # as a list: restore tuples so the config stays hashable
        kind, params = cfg_dict["rope_scaling"]
        if isinstance(params, list):
            params = tuple(params)
        cfg_dict["rope_scaling"] = (kind, params)
    cfg = LlamaConfig(**cfg_dict)
    flat = {}
    with np.load(path) as z:
        for k in z.files:
            arr = z[k]
            if k in dtypes:
                np_view, _ = _CARRY[arr.dtype.itemsize]
                t = torch.from_numpy(arr.view(np_view)).view(
                    getattr(torch, dtypes[k]))
            else:
                t = torch.from_numpy(arr)
            flat[k] = t.to(device)
    return cfg, _unflatten(flat)

