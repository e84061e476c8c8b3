"""Sharding-aware training checkpoints (thin wrapper over
``distributed.fault``); the port of ``repro.train.checkpoint``.

Trees are flattened to path-keyed arrays (``params/...`` and
``opt/...``) in the reference's ``.npz`` format, so a checkpoint of
either package loads into the other: a bf16 leaf is stored as its raw
two bytes an entry (numpy's ``V2``, as the reference's ``bfloat16``
arrays are saved) and ``interop`` reads it back as bf16.

``place`` re-places a host tree onto the current mesh with the model's
partition specs, so a checkpoint written on 512 ranks restores onto 256
or onto one process unchanged.  Each rank keeps its block of every leaf,
cut by ``distributed.sharding.local_block`` -- the port's convention
since the sharded solve (``fault.reshard`` places LP state the same
way).  ``DTensor`` is not used: it needs a ``DeviceMesh`` over an
initialised process group, which the one-process mesh (the CPU tests,
a single card) does not have, while a block cut from the whole array
is the same on every backend and without one.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..distributed import fault
from ..distributed.sharding import local_block
from ..interop import _leaf_tensor


def _host(leaf) -> np.ndarray:
    """A leaf as numpy, a bf16 tensor as its raw bytes (``V2``)."""
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.dtype("V2"))
        return leaf.numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = _host(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def train_state_arrays(params, opt_state) -> Dict[str, np.ndarray]:
    """The flat ``params/...`` and ``opt/...`` arrays of a checkpoint."""
    arrays = {}
    arrays.update({f"params/{k}": v for k, v in _flatten(params).items()})
    arrays.update({f"opt/{k}": v for k, v in _flatten(opt_state).items()})
    return arrays


def save_train_state(path: str, step: int, params, opt_state,
                     meta: Optional[dict] = None) -> str:
    return fault.save_checkpoint(path, step,
                                 train_state_arrays(params, opt_state), meta)


def load_train_state(path: str):
    """(step, params, opt_state, meta), the trees as host numpy arrays
    (bf16 leaves as ``V2``: ``interop.params_from_reference`` and
    ``opt_state_from_reference`` place them)."""
    ck = fault.load_checkpoint(path)
    params = _unflatten({k[len("params/"):]: v for k, v in ck.arrays.items()
                         if k.startswith("params/")})
    opt_state = _unflatten({k[len("opt/"):]: v for k, v in ck.arrays.items()
                            if k.startswith("opt/")})
    return ck.step, params, opt_state, ck.meta


def place(tree, mesh, specs_tree):
    """Each leaf of a host tree (numpy arrays or tensors), cut to this
    rank's block under the parallel spec tree (tuples of axis names, as
    ``models.lm.partition_specs`` gives them), on the mesh's device."""
    def go(leaf, spec):
        if isinstance(leaf, dict):
            return {k: go(v, spec[k]) for k, v in leaf.items()}
        whole = leaf if torch.is_tensor(leaf) else _leaf_tensor(leaf, "cpu",
                                                                  None)
        return local_block(whole, mesh, spec).contiguous().to(mesh.device)

    return go(tree, specs_tree)
