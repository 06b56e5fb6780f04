"""Weights between the JAX package and the port.

The JAX package's entity table and decoder parameter tree, handed over as
numpy arrays (``np.asarray`` of each leaf), become the port's tensors
(:func:`from_jax`, serving), and its whole KGE parameter tree becomes the
port's ``KGEModel`` and back (:func:`kge_model_from_jax`,
:func:`kge_model_to_jax`), so both packages can start from the same
weights. An int8 table in the reference's ``{"codes", "scales"}`` form
crosses both ways bit for bit (:func:`quantized_table_from_jax`,
:func:`quantized_table_to_jax`), and so do an LM parameter tree
(:func:`lm_params_from_jax`, :func:`lm_params_to_jax`) and an RGAT one
(:func:`rgat_params_from_jax`, :func:`rgat_params_to_jax`).
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.decoders import Decoder, get_decoder


def _f32_array(name: str, x) -> np.ndarray:
    a = np.asarray(x)
    if a.dtype != np.float32:
        raise TypeError(f"{name} must be float32, got {a.dtype}")
    return a


def from_jax(entity_emb, decoder_params: Mapping, *,
             decoder: Optional[Union[str, Decoder]] = None,
             device=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(N, d)`` float32 entity table and the decoder's parameter tree
    (name → float32 array) → ``(table tensor, {name: tensor})`` on
    ``device`` (default ``cuda``), copied.

    With ``decoder`` the parameter names and shapes are checked against the
    decoder's own (``Decoder.param_shapes``) for the table's width; without
    it every parameter must at least be a 2-D float32 array with the same
    number of rows."""
    dev = resolve_device(device)
    emb = _f32_array("entity_emb", entity_emb)
    if emb.ndim != 2:
        raise ValueError(f"entity_emb must be (N, d), got {emb.shape}")
    params = {str(k): _f32_array(f"decoder_params[{k!r}]", v)
              for k, v in decoder_params.items()}
    if not params:
        raise ValueError("decoder_params is empty")
    rows = {p.shape[0] if p.ndim else None for p in params.values()}
    if len(rows) != 1 or None in rows or any(
            p.ndim != 2 for p in params.values()):
        raise ValueError(
            "decoder parameters must be 2-D tables over one relation "
            f"vocabulary, got shapes { {k: p.shape for k, p in params.items()} }")
    if decoder is not None:
        want = get_decoder(decoder).param_shapes(rows.pop(), emb.shape[1])
        got = {k: p.shape for k, p in params.items()}
        if got != want:
            raise ValueError(
                f"decoder {get_decoder(decoder).name!r} expects parameters "
                f"{want} for d={emb.shape[1]}, got {got}")
    return (torch.tensor(emb, device=dev),
            {k: torch.tensor(p, device=dev) for k, p in params.items()})


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """The reference's parameter tree (dicts and lists of arrays) as dotted
    names → numpy arrays: ``layers.0.bases``, ``decoder.rel_diag``, … —
    the port's ``named_parameters`` names."""
    out: Dict[str, np.ndarray] = {}
    items = (tree.items() if isinstance(tree, Mapping)
             else enumerate(tree))
    for key, value in items:
        name = f"{prefix}{key}"
        if isinstance(value, (Mapping, list, tuple)):
            out.update(flatten_tree(value, name + "."))
        else:
            out[name] = np.asarray(value)
    return out


def kge_model_from_jax(tree: Mapping, cfg, *, device=None):
    """The reference's ``init_kge_params`` tree (numpy leaves: ``np.asarray``
    of each) → a :class:`repro_torch.models.kge.KGEModel` for ``cfg`` (a
    port ``KGEConfig``) on ``device`` (default ``cuda``). Every name and
    shape must match the model's — a row-sharded ``(S, rows, d)`` entity
    table needs ``cfg.rgcn.num_table_shards == S``; values are copied bit
    for bit."""
    from repro_torch.models.kge import KGEModel
    dev = resolve_device(device)
    flat = flatten_tree(tree)
    model = KGEModel(cfg, dev)
    want = {n: tuple(p.shape) for n, p in model.named_parameters()}
    got = {n: tuple(a.shape) for n, a in flat.items()}
    if got != want:
        raise ValueError(f"parameter tree does not match the model: "
                         f"expected {want}, got {got}")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.tensor(_f32_array(name, flat[name])))
    return model


def kge_tree(named: Iterable[Tuple[str, object]]) -> Dict:
    """``(dotted name, leaf)`` pairs of a KGE model (``named_parameters``
    names, or an optimizer moment's keys) → the reference's tree layout
    (``{"entity_embedding", "layers": [{...}, ...], "decoder": {...}}``),
    the leaves as given. The inverse of :func:`flatten_tree` on that
    layout."""
    tree: Dict = {}
    for name, value in named:
        parts = name.split(".")
        if parts[0] == "layers":
            layers = tree.setdefault("layers", [])
            i = int(parts[1])
            while len(layers) <= i:
                layers.append({})
            layers[i][parts[2]] = value
        elif parts[0] == "decoder":
            tree.setdefault("decoder", {})[parts[1]] = value
        else:
            tree[name] = value
    return tree


def kge_model_to_jax(model) -> Dict:
    """A :class:`KGEModel` → the reference's tree layout with numpy leaves
    (:func:`kge_tree`); a row-sharded entity table stays ``(S, rows, d)``,
    as the reference stores it."""
    return kge_tree((name, p.detach().cpu().numpy().copy())
                    for name, p in model.named_parameters())


def quantized_table_from_jax(quantized: Mapping, *, device=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``quantize_table`` dict (``codes`` int8 of shape
    ``(..., rows, d)``, ``scales`` float32 of shape ``(..., rows)``, numpy
    or ``np.asarray``-able) → ``(codes, scales)`` tensors on ``device``
    (default ``cuda``), copied bit for bit."""
    dev = resolve_device(device)
    codes, scales = np.asarray(quantized["codes"]), np.asarray(
        quantized["scales"])
    if codes.dtype != np.int8:
        raise TypeError(f"codes must be int8, got {codes.dtype}")
    scales = _f32_array("scales", scales)
    if codes.ndim < 2 or scales.shape != codes.shape[:-1]:
        raise ValueError(f"codes {codes.shape} and scales {scales.shape} "
                         f"are not (..., rows, d) and (..., rows)")
    return torch.tensor(codes, device=dev), torch.tensor(scales, device=dev)


def quantized_table_to_jax(codes: torch.Tensor, scales: torch.Tensor
                           ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`quantized_table_from_jax`: the
    ``{"codes", "scales"}`` dict with numpy leaves."""
    return {"codes": codes.detach().cpu().numpy().copy(),
            "scales": scales.detach().cpu().numpy().copy()}


def _map_leaves(tree, fn, prefix: str = ""):
    """``tree`` (dicts and lists) with each leaf replaced by
    ``fn(dotted name, leaf)``."""
    if isinstance(tree, Mapping):
        return {k: _map_leaves(v, fn, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(v, fn, f"{prefix}{i}.")
                for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def lm_params_from_jax(tree: Mapping, cfg, *, device=None) -> Dict:
    """The reference's LM ``init_params`` tree for ``cfg`` (float32 leaves,
    numpy or ``np.asarray``-able; scanned groups stacked ``(L, ...)``) →
    the port's tree (``repro_torch.nn.init_params``' layout, the same
    nesting) on ``device`` (default ``cuda``). Every name and shape must
    match the port's for ``cfg``; values are copied bit for bit."""
    from repro_torch.nn.transformer import init_params, leaves
    dev = resolve_device(device)
    flat = flatten_tree(tree)
    want = {n: tuple(t.shape) for n, t in
            leaves(init_params(cfg, generator=None, device="meta"))}
    got = {n: tuple(a.shape) for n, a in flat.items()}
    if got != want:
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         f"expected {want}, got {got}")
    return _map_leaves(tree, lambda name, _: torch.tensor(
        _f32_array(name, flat[name]), device=dev))


def lm_params_to_jax(params: Mapping) -> Dict:
    """Inverse of :func:`lm_params_from_jax`: the same nesting with numpy
    leaves, bit for bit."""
    return _map_leaves(params,
                       lambda _, t: t.detach().cpu().numpy().copy())


def rgat_params_from_jax(tree: Mapping, cfg, *, device=None) -> Dict:
    """The reference's ``init_rgat_params`` tree (float32 leaves, numpy or
    ``np.asarray``-able) → the port's tree for ``cfg`` (a port
    ``RGATConfig``) on ``device`` (default ``cuda``): the same nesting,
    every name and shape checked against ``init_rgat_params``', values
    copied bit for bit."""
    from repro_torch.models.rgat import init_rgat_params
    dev = resolve_device(device)
    flat = flatten_tree(tree)
    want = {n: tuple(a.shape) for n, a in flatten_tree(
        init_rgat_params(np.random.default_rng(0), cfg)).items()}
    got = {n: tuple(a.shape) for n, a in flat.items()}
    if got != want:
        raise ValueError(f"parameter tree does not match the RGAT config: "
                         f"expected {want}, got {got}")
    return _map_leaves(tree, lambda name, _: torch.tensor(
        _f32_array(name, flat[name]), device=dev))


def rgat_params_to_jax(params: Mapping) -> Dict:
    """Inverse of :func:`rgat_params_from_jax`: the same nesting with numpy
    leaves, bit for bit."""
    return _map_leaves(params,
                       lambda _, t: t.detach().cpu().numpy().copy())
