"""Tree checkpointing: npz arrays + json structure (no external deps) — the
port of ``repro.checkpoint.io``, in its on-disk format.

Layout: ``<dir>/step_<N>/arrays.npz`` (leaf i as ``a<i>``, leaves in JAX's
pytree order: :mod:`repro_torch.tree`) + ``tree.json`` (the structure as
JAX prints it, the leaf count, the step); written atomically through a
``.tmp`` directory and a rename. A checkpoint either package writes
restores in the other. numpy has no bfloat16 of its own: a bf16 tensor is
written widened to float32 (exact) and restored in the dtype of ``like``'s
leaf; a bf16 array the reference wrote (numpy reads it back as 2-byte
void) is widened the same way.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _widen_bf16(arr: np.ndarray) -> np.ndarray:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        bits = arr.view(np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32)
    return arr


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    leaves = tree_lib.leaves(tree)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = {f"a{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump({"treedef": tree_lib.treedef_str(tree), "n": len(leaves),
                   "step": step}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def restore_checkpoint(ckpt_dir: str, like: Any,
                       step: Optional[int] = None) -> Any:
    """Restore into the structure of ``like`` (the structure's source of
    truth). A tensor leaf of ``like`` comes back as a tensor of its dtype
    on its device; any other leaf as the stored numpy array."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    data = np.load(os.path.join(path, "arrays.npz"))
    leaves = tree_lib.leaves(like)
    if len(leaves) != len(data.files):
        raise ValueError(f"checkpoint has {len(data.files)} leaves, "
                         f"expected {len(leaves)}")
    new_leaves = []
    for i, old in enumerate(leaves):
        new = _widen_bf16(data[f"a{i}"])
        shape = tuple(np.shape(old) if not isinstance(old, torch.Tensor)
                      else old.shape)
        if shape != tuple(new.shape):
            raise ValueError(f"shape mismatch {shape} vs {new.shape}")
        if isinstance(old, torch.Tensor):
            new = torch.from_numpy(new).to(device=old.device, dtype=old.dtype)
        new_leaves.append(new)
    return tree_lib.unflatten(like, new_leaves)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None
