"""Checkpoints: save and restore trees of tensors as ``.npz`` plus a JSON
manifest (port of ``repro/training/checkpoint.py``, in its format).

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
tensors or numpy arrays; ``None`` is no leaf. Each leaf is saved under its
``/``-joined path (dict key, list index, NamedTuple field name), dict keys
in sorted order, as the reference's ``jax.tree_util`` paths give them, so
either package restores the other's checkpoints: ``ckpt_{step:08d}.npz``
holds the arrays and ``ckpt_{step:08d}.json`` ``{"step", "keys" (sorted),
"metadata"}``. A restore is checked against the structure, shapes and
table layouts of a tree ``like`` and returns ``like``'s structure, each
leaf with ``like``'s dtype on ``like``'s device (numpy where ``like``
holds numpy).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding.embedding import (
    convert_table_layout, dequantize_rows, quantize_rows,
)

Tree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves_with_path(tree: Tree, prefix: str = ""
                          ) -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in the reference's order: dict keys sorted,
    sequences in order, NamedTuples by field; ``None`` is no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        yield prefix[:-1], tree
        return
    for key, value in items:
        yield from tree_leaves_with_path(value, f"{prefix}{key}/")


def _rebuild(tree: Tree, leaves: Iterator[Any]) -> Tree:
    """``tree``'s structure with its leaves taken from ``leaves`` in
    :func:`tree_leaves_with_path`'s order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def _like(arr: np.ndarray, leaf):
    """``arr`` as ``leaf`` holds it: a tensor of its dtype on its device,
    or a numpy array of its dtype."""
    if isinstance(leaf, torch.Tensor):
        return torch.as_tensor(arr).to(device=leaf.device, dtype=leaf.dtype)
    return np.asarray(arr).astype(np.asarray(leaf).dtype, copy=False)


def save_checkpoint(directory: str, step: int, tree: Tree,
                    metadata: Optional[Dict] = None, keep: int = 3) -> str:
    """Write ``tree`` as ``ckpt_{step:08d}.npz`` and its manifest, then keep
    the newest ``keep`` checkpoints (:func:`_garbage_collect`). Returns the
    ``.npz`` path."""
    os.makedirs(directory, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in tree_leaves_with_path(tree)}
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    np.savez(path, **arrays)
    manifest = {"step": step, "keys": sorted(arrays),
                "metadata": metadata or {}}
    with open(path.replace(".npz", ".json"), "w") as f:
        json.dump(manifest, f, indent=1)
    _garbage_collect(directory, keep)
    return path


def _garbage_collect(directory: str, keep: int) -> None:
    """Prune old checkpoints, the newest ``keep`` kept; ``keep <= 0`` keeps
    everything. Manifests whose ``.npz`` is gone are removed either way, so
    that :func:`latest_checkpoint` and the window never count a step that
    has no arrays."""
    names = os.listdir(directory)
    ckpts = sorted(f for f in names if re.fullmatch(r"ckpt_\d+\.npz", f))
    live = set(ckpts)
    for f in names:
        if re.fullmatch(r"ckpt_\d+\.json", f) and \
                f.replace(".json", ".npz") not in live:
            os.remove(os.path.join(directory, f))
    if keep <= 0:
        return
    for old in ckpts[:-keep]:
        os.remove(os.path.join(directory, old))
        manifest = os.path.join(directory, old.replace(".npz", ".json"))
        if os.path.exists(manifest):
            os.remove(manifest)


def latest_checkpoint(directory: str) -> Optional[str]:
    """The newest ``.npz`` in ``directory``, or ``None``."""
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(f for f in os.listdir(directory)
                   if re.fullmatch(r"ckpt_\d+\.npz", f))
    return os.path.join(directory, ckpts[-1]) if ckpts else None


def read_metadata(path: str) -> Tuple[int, Dict]:
    """``(step, metadata)`` from a checkpoint's manifest: the trainer's
    own state (epoch, generator key) lives there, beside the arrays."""
    with open(path.replace(".npz", ".json")) as f:
        manifest = json.load(f)
    return manifest["step"], manifest.get("metadata", {})


def restore_checkpoint(path: str, like: Tree,
                       entity_rows: Optional[int] = None
                       ) -> Tuple[int, Tree]:
    """``(step, tree)``: the checkpoint in ``like``'s structure, each leaf's
    shape checked against ``like``'s.

    An entity table (a leaf named ``entity_embedding``) restores across
    layouts: dense ``(V, d)`` into row-sharded ``(S, rows, d)`` and back,
    at any shard counts (:func:`convert_table_layout`); ``entity_rows``,
    the model's true entity count, closes the window a sharded shape's
    tail padding leaves. Every other leaf must match its shape exactly.

    A quantized table is ``entity_embedding/{codes, scales}``, and four
    conversions compose with the layout's (through the port's
    ``quantize_rows`` / ``dequantize_rows`` on CPU tensors, bitwise the
    reference's):

    * quantized → quantized across shard counts: codes and scales are
      padded or trimmed, never requantized (padding rows are zero codes
      and a zero scale), so the bits are kept;
    * quantized checkpoint → fp32 tree: dequantized (exact), then the
      layout converted;
    * fp32 checkpoint → quantized tree: the layout converted first, then
      one deterministic quantization shared by the codes and scales
      leaves;
    * anything else (a wrong dtype, a wrong row count) raises.
    """
    with np.load(path) as npz:
        data = {k: npz[k] for k in npz.files}
    with open(path.replace(".npz", ".json")) as f:
        manifest = json.load(f)
    flat = list(tree_leaves_with_path(like))
    shapes = {k: _shape(v) for k, v in flat}
    names = set(data)

    def convert_scales(arr, target_shape):
        # scales are (..., rows): a table with d = 1 to the layout's pad
        # and trim
        return convert_table_layout(arr[..., None],
                                    tuple(target_shape) + (1,),
                                    num_rows=entity_rows)[..., 0]

    requantized_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def requantized(parent, codes_shape):
        # the fp32 table in the tree's layout (a row's amax does not
        # depend on the layout; padding rows quantize to zero), quantized
        # once for both leaves
        if parent not in requantized_cache:
            src = data[parent]
            if src.dtype != np.float32:
                raise ValueError(
                    f"cannot quantize checkpoint leaf {parent!r} of dtype "
                    f"{src.dtype} into an int8 table: expected float32")
            codes, scales = quantize_rows(torch.from_numpy(
                convert_table_layout(src, codes_shape,
                                     num_rows=entity_rows)))
            requantized_cache[parent] = (codes.numpy(), scales.numpy())
        return requantized_cache[parent]

    out: List[Any] = []
    for k, v in flat:
        want = shapes[k]
        parts = k.split("/")
        leaf = parts[-1]
        parent = "/".join(parts[:-1])
        quant_leaf = (leaf in ("codes", "scales") and len(parts) >= 2
                      and parts[-2] == "entity_embedding")
        if k in names:
            arr = data[k]
            if arr.shape != want:
                if leaf == "entity_embedding":
                    arr = convert_table_layout(arr, want,
                                               num_rows=entity_rows)
                elif quant_leaf and leaf == "codes":
                    if arr.dtype != np.int8:
                        raise ValueError(
                            f"dtype mismatch at {k}: checkpoint {arr.dtype} "
                            f"vs int8 codes: not a quantized table")
                    arr = convert_table_layout(arr, want,
                                               num_rows=entity_rows)
                elif quant_leaf:
                    arr = convert_scales(arr, want)
                else:
                    raise ValueError(
                        f"shape mismatch at {k}: checkpoint {arr.shape} vs "
                        f"tree {want}")
        elif leaf == "entity_embedding" and f"{k}/codes" in names:
            # a quantized checkpoint into an fp32 tree
            codes = data[f"{k}/codes"]
            if codes.dtype != np.int8:
                raise ValueError(
                    f"dtype mismatch at {k}/codes: checkpoint {codes.dtype} "
                    f"vs int8: not a quantized table")
            arr = convert_table_layout(
                dequantize_rows(torch.from_numpy(codes), torch.from_numpy(
                    data[f"{k}/scales"])).numpy(), want,
                num_rows=entity_rows)
        elif quant_leaf and parent in names:
            # an fp32 checkpoint into a quantized tree: the codes leaf
            # fixes the row layout
            codes_shape = shapes.get(f"{parent}/codes",
                                     want if leaf == "codes"
                                     else want + want[-1:])
            codes, scales = requantized(parent, codes_shape)
            arr = codes if leaf == "codes" else scales
        else:
            raise KeyError(f"checkpoint missing leaf {k!r}")
        if arr.shape != want:
            raise ValueError(f"shape mismatch at {k}: converted {arr.shape} "
                             f"vs tree {want}")
        out.append(_like(arr, v))
    return manifest["step"], _rebuild(like, iter(out))
