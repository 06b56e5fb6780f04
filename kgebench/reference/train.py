"""The plain training step a training cell's window must match: RGCN with
the basis decomposition (Schlichtkrull et al., 2018; paper Eq. 1) and
DistMult over each trainer's padded self-sufficient partition, the paper's
constraint-based negatives, binary cross-entropy (Eq. 3), the trainers'
gradients averaged (Algorithm 1) and one Adam step.

Plain PyTorch, autograd for the gradients, in float64 or in float32 (a
training cell holds the program to the nearer of the two); it imports
nothing of the program. It draws its weights, negatives and dropout masks again from the
seed, by the schedule the port documents: the weights from numpy's
generator of the seed (Glorot-normal table and layers, then the relation
diagonals), and per epoch one ``torch.Generator`` per trainer, seeded
through numpy's ``SeedSequence([seed + 1, epoch])``, which draws the
negatives first (head or tail, then the replacement among the core
vertices), then each layer's dropout mask.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

ADAM = dict(b1=0.9, b2=0.999, eps=1e-8)


def glorot(rng: np.random.Generator, shape) -> np.ndarray:
    fan_in, fan_out = (shape[-2] if len(shape) > 1 else 1), shape[-1]
    return (rng.standard_normal(tuple(shape))
            * np.sqrt(2.0 / (fan_in + fan_out))).astype(np.float32)


def leaf_shapes(model: Dict, num_entities: int,
                num_relations: int) -> Dict[str, tuple]:
    """Each parameter's shape, in the order they are drawn."""
    d, nb = model["hidden_dim"], model["num_bases"]
    shapes = {}
    if model.get("feature_dim") is None:
        shapes["entity_embedding"] = (num_entities, d)
    for i in range(model["num_hops"]):
        d_in = (model.get("feature_dim") or d) if i == 0 else d
        shapes[f"layers.{i}.bases"] = (nb, d_in, d)
        shapes[f"layers.{i}.coeffs"] = (num_relations, nb)
        shapes[f"layers.{i}.self_weight"] = (d_in, d)
    shapes["decoder.rel_diag"] = (num_relations, d)
    return shapes


def init_params(model: Dict, num_entities: int, num_relations: int,
                seed: int, device) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in leaf_shapes(model, num_entities,
                                   num_relations).items():
        if name == "decoder.rel_diag":
            w = (rng.standard_normal(shape)
                 * (1.0 / np.sqrt(shape[1]))).astype(np.float32)
        else:
            w = glorot(rng, shape)
        out[name] = torch.from_numpy(w).to(device)
    return out


def trainer_generators(seed: int, trainers: int, epoch: int,
                       device) -> List[torch.Generator]:
    gens = []
    for s in np.random.SeedSequence([seed, epoch]).spawn(trainers):
        g = torch.Generator(device=device)
        g.manual_seed(int(s.generate_state(1, np.uint64)[0] >> 1))
        gens.append(g)
    return gens


def negatives(pos: torch.Tensor, num_core: int, s: int,
              gen: torch.Generator) -> torch.Tensor:
    b = pos.shape[0]
    head = torch.rand((b, s), generator=gen, device=pos.device) < 0.5
    repl = torch.randint(0, max(num_core, 1), (b, s), generator=gen,
                         device=pos.device, dtype=pos.dtype)
    p = pos[:, None, :].expand(b, s, 3)
    neg = torch.stack([torch.where(head, repl, p[..., 0]), p[..., 1],
                       torch.where(head, p[..., 2], repl)], dim=-1)
    return neg.reshape(b * s, 3)


def trainer_loss(params: Dict[str, torch.Tensor], part: Dict, model: Dict,
                 gen: torch.Generator,
                 features: Optional[torch.Tensor]) -> torch.Tensor:
    """One trainer's loss on its padded partition."""
    src, rel, dst = part["src"], part["rel"], part["dst"]
    on = part["edge_mask"]
    pos = torch.stack([src, rel, dst], dim=1)
    neg = negatives(pos, int(part["num_core_vertices"]),
                    model["num_negatives"], gen)
    table = params.get("entity_embedding", features)
    h = table[part["local_to_global"]] * part["vertex_mask"][:, None]
    v = h.shape[0]
    src_l, dst_l = src.long(), dst.long()
    deg = torch.zeros(v, device=h.device, dtype=h.dtype).index_add_(
        0, src_l, on.to(h.dtype))
    keep_p = 1.0 - model["dropout"]
    layers = model["num_hops"]
    for i in range(layers):
        bases = params[f"layers.{i}.bases"]
        coef = params[f"layers.{i}.coeffs"][rel.long()]
        proj = torch.einsum("ed,bdo->ebo", h[dst_l], bases)
        msg = torch.einsum("ebo,eb->eo", proj, coef) * on[:, None]
        agg = torch.zeros(v, bases.shape[2], device=h.device,
                          dtype=h.dtype).index_add_(
            0, src_l, msg) / torch.clamp_min(deg, 1.0)[:, None]
        out = agg + h @ params[f"layers.{i}.self_weight"]
        if i < layers - 1:
            out = torch.relu(out)
        keep = torch.rand(out.shape, generator=gen, device=h.device,
                          dtype=torch.float32) < keep_p
        h = torch.where(keep, out / keep_p, torch.zeros_like(out))
    trip = torch.cat([pos, neg]).long()
    scores = (h[trip[:, 0]] * params["decoder.rel_diag"][trip[:, 1]]
              * h[trip[:, 2]]).sum(dim=-1)
    n_pos = pos.shape[0]
    labels = torch.cat([
        torch.ones(n_pos, device=h.device, dtype=h.dtype),
        torch.zeros(trip.shape[0] - n_pos, device=h.device, dtype=h.dtype)])
    mask = part["core_edge_mask"].to(h.dtype).repeat(
        1 + model["num_negatives"])
    per = (torch.clamp_min(scores, 0) - scores * labels
           + torch.log1p(torch.exp(-torch.abs(scores))))
    return (per * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def adam_step(params, grads, mu, nu, t: int, lr: float) -> None:
    b1, b2, eps = ADAM["b1"], ADAM["b2"], ADAM["eps"]
    # the bias corrections from the float32 values of b1 and b2, as a
    # float32 Adam forms them: 1 - b2 cancels, and float32's 0.999 leaves
    # 1 - b2 1.3e-5 off the decimal value's, 6.4e-6 in every step's size
    bc1 = 1 - float(np.float32(b1)) ** t
    bc2 = 1 - float(np.float32(b2)) ** t
    for k in params:
        g = grads[k]
        mu[k] = b1 * mu[k] + (1 - b1) * g
        nu[k] = b2 * nu[k] + (1 - b2) * g * g
        delta = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
        params[k] = params[k] - lr * delta


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """IEEE float32 products, or TF32 ones for the precision control."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def follow(padded: Dict[str, np.ndarray], model: Dict, recipe: Dict,
           num_entities: int, num_relations: int, seed: int, steps: int,
           device, features: Optional[np.ndarray] = None,
           dtype: torch.dtype = torch.float64, tf32: bool = False) -> Dict:
    """The first ``steps`` full-batch steps from the seed's weights, in
    ``dtype`` (with TF32 products where ``tf32``, for the precision
    control): ``{"losses": [...], "grad_norms": {leaf: norm of step 1's
    mean gradient}, "step1_change_norms": {leaf: norm of the change after
    step 1}, "change_norms": {leaf: norm of the change after the
    steps}}``. The trainers run one after another, one graph alive at a
    time."""
    feats = None if features is None else torch.from_numpy(features).to(
        device, dtype)
    params = {k: v.to(dtype) for k, v in init_params(
        model, num_entities, num_relations, seed, device).items()}
    start = {k: v.clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    trainers = padded["src"].shape[0]
    parts = [{k: (torch.from_numpy(np.asarray(v[i])).to(device)
                  if k not in ("num_core_vertices", "num_core_edges")
                  else int(v[i]))
              for k, v in padded.items()} for i in range(trainers)]
    losses, grad_norms, step1 = [], None, None
    with matmul_precision(tf32):
        for epoch in range(1, steps + 1):
            gens = trainer_generators(seed + 1, trainers, epoch, device)
            total, step_losses = None, []
            for part, gen in zip(parts, gens):
                leaves = {k: v.detach().requires_grad_(True)
                          for k, v in params.items()}
                loss = trainer_loss(leaves, part, model, gen, feats)
                grads = torch.autograd.grad(loss, list(leaves.values()),
                                            allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(leaves.values(), grads)]
                total = grads if total is None else [
                    a + g for a, g in zip(total, grads)]
                step_losses.append(float(loss.detach()))
                del leaves, loss, grads
            mean = {k: g / trainers for k, g in zip(params, total)}
            if grad_norms is None:
                grad_norms = {k: float(g.norm()) for k, g in mean.items()}
            with torch.no_grad():
                adam_step(params, mean, mu, nu, epoch,
                          recipe["learning_rate"])
            losses.append(float(np.mean(step_losses)))
            if step1 is None:
                step1 = {k: float((params[k] - start[k]).norm())
                         for k in params}
    change = {k: float((params[k] - start[k]).norm()) for k in params}
    return {"losses": losses, "grad_norms": grad_norms,
            "step1_change_norms": step1, "change_norms": change}
