"""Checkpoints in the JAX package's layout
(port of ``cmw_rag_tpu/models/common.py:147-180 save/load_params_npz``).

A checkpoint npz holds ``arr_0 … arr_n`` in JAX tree-leaf order, which
walks lists in order and SORTS dict keys at every level. For a T5 layer
that is ``attn_norm, ffn_norm, wi_gelu, wi_lin, wk, wo, wo_ff, wq, wv``;
``wk``, ``wo``, ``wq`` and ``wv`` share one shape, so an order taken from
anything else (insertion order, ``state_dict()``) loads without error and
swaps Q, K and V. ``tree_leaves`` below is the one place that order lives.
bf16 leaves are stored as float32; the loader casts each array to the dtype
the model's layout asks for.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch


class Leaf(NamedTuple):
    """Shape and dtype of one parameter in a model's layout tree."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def tree_leaves(tree: Any) -> list:
    """Leaves in JAX tree order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Leaf):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree: Any) -> Any:
    """Apply ``fn`` to every leaf, keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Leaf):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_unflatten(like: Any, leaves: list) -> Any:
    """Inverse of ``tree_leaves`` over the structure of ``like``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)) and not isinstance(node, Leaf):
            return [build(v) for v in node]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def _to_tensor(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # ml_dtypes array from a JAX tree
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


def load_params_npz(layout: Any, path, device="cpu") -> Any:
    """Read a JAX-package checkpoint into tensors shaped by ``layout`` (a
    tree of ``Leaf``). Raises on a count or shape mismatch."""
    with np.load(path, allow_pickle=False) as data:
        names = sorted(data.files, key=lambda s: int(s.split("_")[1]))
        arrays = [data[k] for k in names]
    leaves = tree_leaves(layout)
    if len(arrays) != len(leaves):
        raise ValueError(f"checkpoint has {len(arrays)} arrays, "
                         f"model needs {len(leaves)}")
    out = []
    for arr, leaf in zip(arrays, leaves):
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch: ckpt {arr.shape} vs "
                             f"model {leaf.shape}")
        out.append(_to_tensor(arr, leaf.dtype, device))
    return tree_unflatten(layout, out)


def save_params_npz(params: Any, path) -> None:
    """Write ``params`` as ``arr_0 … arr_n`` in JAX tree-leaf order, the
    layout ``load_params_npz`` here and in the JAX package read. bf16 leaves
    are stored as float32 (numpy has no bf16); float32, float64, float16,
    int32 and int64 leaves as they are, as the JAX writer keeps them."""
    keep = (torch.float32, torch.float64, torch.float16, torch.int32,
            torch.int64)
    arrays = []
    for t in tree_leaves(params):
        t = t.detach()
        arrays.append((t if t.dtype in keep else t.float()).cpu().numpy())
    np.savez(path, *arrays)


def params_from_jax(tree: Any, device="cpu") -> Any:
    """Carry a JAX parameter tree, given as numpy arrays
    (``jax.tree.map(np.asarray, params)``), into the port's tensors. bf16
    leaves stay bf16, float32 leaves stay float32."""
    def conv(a):
        a = np.asarray(a)
        dtype = (torch.bfloat16 if a.dtype.name == "bfloat16"
                 else torch.from_numpy(np.zeros(0, a.dtype)).dtype)
        return _to_tensor(a, dtype, device)

    return tree_map(conv, tree)

