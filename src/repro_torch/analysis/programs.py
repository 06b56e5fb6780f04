"""Run every multi-process program of the port under the recorder and audit
its CommContract (port of ``repro/analysis/programs.py``).

Program inventory (each ran once under ``analysis.trace.CommRecorder``,
each rank auditing its own trace, as the reference audits each device's
HLO):

* ``train[<exchange>(,dedup)(,int8)]``: one real step (forward, backward,
  update) of ``training.distributed.make_spmd_train_step`` as
  ``KGETrainer`` wires it under ``spmd``, on the pipeline's first batch,
  per exchange in ``SPMD_EXCHANGES`` × gather dedup, and the int8 table
  on the default exchange. Contract: the exchange's collectives on the
  ``model`` axis with closed-form wire bytes from the batch's plan width,
  the gradient gather on the ``data`` axis, nothing else; no output of
  full-table shape; the rank's parameters (its table block among them)
  and Adam moments keep their storage.
* ``rank[<protocol>]``: ``eval.sharded.make_sharded_rank_step``, both
  protocols. Contract: the true-score and integer-count ``all_reduce`` s
  on the ``model`` axis, exact bytes; no dimension ``V``.
* ``eval[all-entities]``: ``KGETrainer.evaluate("test")`` under spmd, the
  streamed encode and the filtered ranking of both directions. Contract:
  the encode's exchange (per partition) and the ranking's head-row,
  true-score and count ``all_reduce`` s (per test batch and direction),
  all on the ``model`` axis, exact bytes; no output with the dimension
  ``V`` (nor ``S·rows``): each rank holds only its row block of the
  embeddings. The reference has no such program.
* ``serve[topk]``, ``serve[topk,int8]``: ``serving.kge.ShardedKGEServer.
  topk_tails`` (the head gather, every shard's ``kge_score`` and top-k,
  the merge). Contract: no collective, no dimension ``V`` (the dense
  ``(B, N)`` score matrix never exists); int8 also no float32 output
  shaped like the code stack ``(S, rows, d)`` or the flat table ``(S·rows,
  d)``.

Every audit also runs its program a second time without the recorder and
holds the outputs (losses, metrics, parameters and moments after the
step; counts; top-k) bitwise equal: recording changes nothing.

The port's closed forms (``U`` the plan width, ``U'`` it padded to a
multiple of ``S``, ``S`` the model axis, ``t_dev`` trainers per rank, f32;
the reference's in brackets where they differ):

=====================  ===============================================
program                collectives and wire bytes
=====================  ===============================================
train[psum]            ``t_dev`` all-reduce ``2·t_dev·U·d·4`` (1)
train[psum_scatter]    ``t_dev`` reduce-scatter ``t_dev·(U'/S)·d·4``
                       and ``t_dev`` all-gather ``t_dev·U'·d·4`` (1 each)
train[alltoall]        ``t_dev`` all-to-all and ``t_dev`` all-gather,
                       ``t_dev·U'·d·4`` each (1 each)
train[...,int8]        codes and f32 scales, ``t_dev·(U'/S)·(d + 4)`` and
                       ``t_dev·U'·(d + 4)``, up to ``2·t_dev`` each
train, data axis       one all-gather of each trainer's flat gradients,
                       loss and aux metrics: ``P·(n_params + 1 + 3)·4``
                       at result size (a pmean all-reduce of
                       ``2·(grad_bytes + 3·4)``)
rank[all-entities]     3 all-reduce ``2·B·(4 + 8 + 8)``: the counts are
                       int64 (s32: ``2·B·(4 + 4 + 4)``)
rank[candidates]       3 all-reduce ``2·B·(4 + 8 + 8)``: the true score
                       is lane 0 of the candidates' own product (2
                       all-reduce ``2·2·B·4``, the true score an input)
eval[all-entities]     per partition (``P``) a reduce-scatter
                       ``(V_p'/S)·d·4`` and an all-gather ``V_p'·d·4``
                       (``V_p'`` the padded vertex count, padded to a
                       multiple of ``S``); per test batch of ``b`` queries
                       and direction 4 all-reduce ``2·b·(4·d + 4 + 8 +
                       8)``: ``8·ceil(T/256)`` all-reduce of
                       ``4·T·(4·d + 20)`` over ``T`` test triplets (no
                       reference program)
serve[topk(,int8)]     none
=====================  ===============================================

The port loops its trainers where the reference vmaps them, so each
exchange collective comes ``t_dev`` times with the same total bytes. The
data axis gathers where the reference averages: adding the gathered rows
in trainer order keeps the real step bitwise the simulated one
(``training/distributed.py``).

On a mesh whose model axis is one rank (``S = 1``) the rank's block is the
whole table: the replication rule naming it is refused by name
(``CommContract.refused``), the collectives are all degenerate, and
``min_recorded`` keeps a recorder that sees nothing from passing. The
train, rank and eval programs need an initialised process group whose
ranks fit the mesh (``launch.mesh.fit_spmd_mesh``); the serve programs
need none.
Run them with ``python -m repro_torch.launch.audit``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.contracts import (
    AuditReport, CollectiveRule, CommContract, audit_trace,
)
from repro_torch.analysis.trace import CommRecorder, storage_ptrs

RANK_PROTOCOLS = ("all-entities", "candidates")
_N_AUX = 3          # the loss's aux metrics: loss, pos/neg score means
_COUNT_BYTES = 8    # the rank counts are int64 (a bool tensor's sum)


@dataclasses.dataclass(frozen=True)
class AuditConfig:
    """One audited configuration — small enough for CPU CI, shaped like
    production (multi-trainer data axis, multi-shard model axis).
    ``rank_entities`` overrides the rank program's ``V = 25·S·d``."""

    num_trainers: int = 2
    num_table_shards: int = 2
    hidden_dim: int = 8
    num_hops: int = 1
    batch_size: int = 64
    data_scale: float = 0.01     # synthetic_fb15k scale (V = 200)
    seed: int = 3
    eval_dim: int = 16
    eval_batch: int = 16
    eval_relations: int = 4
    num_candidates: int = 8
    serve_batch: int = 8
    serve_k: int = 5
    rank_entities: Optional[int] = None


def _guard_dims(name: str, legit: Sequence[int],
                forbidden: Sequence[int]) -> None:
    clash = sorted(set(legit) & set(forbidden))
    if clash:
        raise ValueError(
            f"degenerate audit config for {name}: legitimate buffer "
            f"dims {clash} collide with the forbidden full-table dims "
            f"{sorted(set(forbidden))} — the replication audit could "
            f"not tell them apart; pick different audit sizes")


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.detach().reshape(-1).view(torch.uint8),
        b.detach().reshape(-1).view(torch.uint8))


def _hold_unchanged(report: AuditReport, on: Dict[str, torch.Tensor],
                    off: Dict[str, torch.Tensor]) -> None:
    """Add a violation for every output whose bits differ between the
    recorded run (``on``) and the plain one (``off``)."""
    bad = sorted(k for k in on if k not in off or
                 not _same_bits(on[k], off[k]))
    if bad or set(off) != set(on):
        report.violations.append(
            f"the recorder changed the program's outputs: {bad}")


def _mesh_axes(mesh) -> Tuple[Tuple[str, int], ...]:
    return (("data", mesh.data), ("model", mesh.model))


# ---------------------------------------------------------------------- #
# train step
# ---------------------------------------------------------------------- #
def _build_trainer(cfg: AuditConfig, exchange: str, dedup: bool,
                   table_dtype: str, device, scale: Optional[float] = None):
    from repro_torch.data import synthetic_fb15k
    from repro_torch.training import KGETrainer, TrainConfig
    splits = synthetic_fb15k(scale=scale or cfg.data_scale, seed=cfg.seed)
    return KGETrainer(splits, TrainConfig(
        num_trainers=cfg.num_trainers,
        num_hops=cfg.num_hops,
        hidden_dim=cfg.hidden_dim,
        batch_size=cfg.batch_size,
        num_table_shards=cfg.num_table_shards,
        gather_exchange=exchange,
        gather_dedup=dedup,
        table_dtype=table_dtype,
        pipeline="serial",
        spmd=True,
        epochs=1,
        seed=cfg.seed,
    ), device=device)


def train_state(tr) -> Dict[str, torch.Tensor]:
    """The tensors one step updates on this rank, by checkpoint path: the
    parameters (the table's row block among them) and the Adam moments."""
    out = {f"params/{n}": p for n, p in tr.params.named_parameters()}
    for part in ("mu", "nu"):
        out.update({f"opt/{part}/{n}": t for n, t in
                    (getattr(tr.opt_state, part) or {}).items()})
    return out


def train_contract(tr, batch: Dict, name: str) -> CommContract:
    """The spmd train step's contract, from the trainer's real mesh and
    parameter placement and the batch's plan width."""
    mesh = tr.mesh
    s, data = mesh.model, mesh.data
    d = int(tr.cfg.hidden_dim)
    t_dev = int(tr.cfg.num_trainers) // data
    exchange = tr.cfg.gather_exchange or "psum_scatter"
    quant = tr.cfg.table_dtype == "int8"
    itm = 4
    rules: List[CollectiveRule] = []
    legit = [d]
    if s > 1:
        u = int(batch["shard_local_ids"].shape[-1])
        u_pad = -(-u // s) * s
        legit += [u, u_pad]
        # int8 on the wire: one byte a code plus the f32 row scale, in two
        # collectives (codes, scales) a trainer
        row_bytes = (d * 1 + 4) if quant else d * itm
        cap = 2 * t_dev if quant else t_dev
        tag = " (int8 codes + f32 scales)" if quant else ""
        if quant and exchange != "psum_scatter":
            raise ValueError(
                f"int8 train contract is only derived for the default "
                f"psum_scatter exchange, not {exchange!r}")
        if exchange == "psum":
            rules.append(CollectiveRule(
                "all-reduce", ("model",), min_count=t_dev, max_count=t_dev,
                expected_bytes=2.0 * t_dev * u * d * itm,
                note="dense table-exchange psum, one a trainer"))
        elif exchange == "psum_scatter":
            rules.append(CollectiveRule(
                "reduce-scatter", ("model",), min_count=t_dev,
                max_count=cap,
                expected_bytes=float(t_dev * (u_pad // s) * row_bytes),
                note="scatter phase of the exchange" + tag))
            rules.append(CollectiveRule(
                "all-gather", ("model",), min_count=t_dev, max_count=cap,
                expected_bytes=float(t_dev * u_pad * row_bytes),
                note="tiled gather phase of the exchange" + tag))
        elif exchange == "alltoall":
            rules.append(CollectiveRule(
                "all-to-all", ("model",), min_count=t_dev, max_count=t_dev,
                expected_bytes=float(t_dev * u_pad * d * itm),
                note="shard-major exchange"))
            rules.append(CollectiveRule(
                "all-gather", ("model",), min_count=t_dev, max_count=t_dev,
                expected_bytes=float(t_dev * u_pad * d * itm),
                note="tiled gather phase of the exchange"))
        else:
            raise ValueError(f"no contract for exchange {exchange!r}")
    n_params = sum(p.numel() for p in tr.params.parameters())
    if data > 1:
        rules.append(CollectiveRule(
            "all-gather", ("data",),
            expected_bytes=float(tr.cfg.num_trainers * (n_params + 1 + _N_AUX)
                                 * itm),
            note="each trainer's flat gradients, loss and aux metrics, "
                 "added in trainer order (Algorithm 1 line 8)"))
    v = int(tr.train_kg.num_entities)
    layout = tr.pre.table_layout
    padded = (layout.num_shards * layout.rows_per_shard
              if layout is not None else v)
    forbidden, refused = tuple({(v, d), (padded, d)}), ()
    if s == 1:
        forbidden, refused = (), (
            f"replication: no ({v}, {d}) output — with a model axis of "
            f"one rank the rank's block is the whole table",)
    else:
        _guard_dims(name, legit, [v, padded])
    return CommContract(
        name=name, mesh_axes=_mesh_axes(mesh), rules=tuple(rules),
        forbidden_suffixes=forbidden, refused=refused,
        min_in_place=tuple(train_state(tr)), min_recorded=1,
        notes=f"V={v} d={d} t_dev={t_dev} mesh={mesh.shape}")


def first_batch(tr) -> Dict[str, torch.Tensor]:
    """The first device batch of epoch 1 (the pipeline is closed after
    it)."""
    it = tr.pipeline.device_batches(1)
    try:
        return next(it)
    finally:
        it.close()


def _train_once(tr, batch, recorder=None) -> Dict[str, torch.Tensor]:
    """One step of ``tr`` on ``batch`` (under ``recorder`` when given);
    returns copies of its outputs: the metrics, then every parameter,
    moment and the step counter after it."""
    from repro_torch.kernels.sharded_gather import raise_if_flagged
    gens = tr.step_generators(1, 0)
    with recorder if recorder is not None else contextlib.nullcontext():
        tr.opt_state, metrics = tr._step(tr.params, tr.opt_state, batch,
                                         gens)
    raise_if_flagged(tr.device)
    out = {f"metrics/{k}": v.detach().clone() for k, v in metrics.items()}
    out.update({k: t.detach().clone() for k, t in train_state(tr).items()})
    out["opt/step"] = tr.opt_state.step.clone()
    return out


def audit_trainer_step(tr, name: str) -> AuditReport:
    """Audit one real step of an spmd trainer ``tr`` (its pipeline's
    first batch, epoch 1's generators): run it under the recorder, then
    again from the same state without it, and leave ``tr`` in the state
    after one step."""
    if tr.mesh is None:
        raise ValueError(f"{name}: the trainer runs the simulated step; "
                         f"the audit needs spmd")
    batch = first_batch(tr)
    state, opt0 = train_state(tr), tr.opt_state
    saved = {k: t.detach().clone() for k, t in state.items()}
    before = storage_ptrs(state)
    recorder = CommRecorder()
    on = _train_once(tr, batch, recorder)
    after = storage_ptrs(train_state(tr))
    recorder.trace.in_place = {k: (before[k], after[k]) for k in before}
    with torch.no_grad():
        for k, t in state.items():
            t.copy_(saved[k])
    tr.opt_state = opt0
    off = _train_once(tr, batch)
    report = audit_trace(recorder.trace, train_contract(tr, batch, name))
    _hold_unchanged(report, on, off)
    return report


def audit_train_step(exchange: str, dedup: bool,
                     cfg: Optional[AuditConfig] = None,
                     table_dtype: str = "fp32", device=None) -> AuditReport:
    """Build the trainer ``KGETrainer`` wires under spmd for one exchange
    × dedup (× table dtype) and audit one real step of it."""
    cfg = cfg or AuditConfig()
    tr = _build_trainer(cfg, exchange, dedup, table_dtype, device)
    try:
        name = (f"train[{exchange}{',dedup' if dedup else ''}"
                f"{',int8' if table_dtype == 'int8' else ''}]")
        return audit_trainer_step(tr, name)
    finally:
        tr.close()


# ---------------------------------------------------------------------- #
# sharded rank step
# ---------------------------------------------------------------------- #
def audit_rank_step(protocol: str, mesh,
                    cfg: Optional[AuditConfig] = None,
                    device=None) -> AuditReport:
    """Run ``make_sharded_rank_step`` for one protocol on ``mesh``'s model
    axis (``num_table_shards`` ranks) and audit it. Inputs as the
    reference builds them: a random ``(V, d)`` table with ``V = 25·S·d``
    (a multiple of ``S``, equal to none of B, d, C, rows), this rank's
    block, its bias block or lane plan."""
    from repro_torch.device import resolve_device
    from repro_torch.eval.sharded import make_sharded_rank_step
    from repro_torch.models.decoders import get_decoder, init_decoder_params
    from repro_torch.sharding.embedding import (
        ShardedTableLayout, plan_local_gather, shard_table,
    )

    cfg = cfg or AuditConfig()
    dev = resolve_device(device)
    s = mesh.model
    if s != cfg.num_table_shards:
        raise ValueError(f"rank[{protocol}]: a model axis of {s} ranks for "
                         f"{cfg.num_table_shards} table shards")
    b, d, c = cfg.eval_batch, cfg.eval_dim, cfg.num_candidates
    v = cfg.rank_entities or 25 * s * d
    layout = ShardedTableLayout(v, s)
    rows = layout.rows_per_shard
    i = mesh.model_index
    rng = np.random.RandomState(cfg.seed)
    emb = rng.standard_normal((v, d)).astype(np.float32)
    dec = get_decoder("distmult")
    dparams = init_decoder_params(np.random.default_rng(cfg.seed), dec,
                                  cfg.eval_relations, d, dev)
    table = shard_table(torch.from_numpy(emb).to(dev), layout)[i:i + 1]
    heads = rng.randint(0, v, size=b)
    rel = torch.from_numpy(rng.randint(0, cfg.eval_relations, size=b)
                           .astype(np.int64)).to(dev)
    q, q_bias = dec.prepare_query(
        dparams, torch.from_numpy(emb[heads]).to(dev), rel)

    def mine(plan):
        return torch.from_numpy(np.ascontiguousarray(plan[i:i + 1])).to(dev)

    if protocol == "all-entities":
        bias = torch.zeros((1, b, rows), dtype=torch.float32, device=dev)
        t_li, t_ow = plan_local_gather(layout, rng.randint(0, v, size=b))
        args = (dparams, table, q, q_bias, bias, mine(t_li).long(),
                mine(t_ow))
        legit = [b, d, rows]
    elif protocol == "candidates":
        lanes = rng.randint(0, v, size=(b, 1 + c))   # lane 0: the true tail
        l_li, l_ow = plan_local_gather(layout, lanes)   # (S, B, 1 + C)
        args = (dparams, table, q, q_bias, mine(l_li).long(), mine(l_ow))
        legit = [b, d, c, 1 + c, rows]
    else:
        raise ValueError(f"unknown rank protocol {protocol!r}")
    step = make_sharded_rank_step(mesh.model_axis, decoder=dec,
                                  protocol=protocol)
    name = f"rank[{protocol}]"

    def run(recorder=None):
        with recorder if recorder is not None else contextlib.nullcontext():
            out = step(*args)
        return dict(zip(("greater", "equal", "true_score"),
                        (t.clone() for t in out)))

    recorder = CommRecorder()
    on = run(recorder)
    off = run()
    rules = (CollectiveRule(
        "all-reduce", ("model",), min_count=3, max_count=3,
        expected_bytes=2.0 * b * (4 + 2 * _COUNT_BYTES),
        note="true-score (f32) and int64 rank-count all-reduces"),)
    forbidden, refused = (v,), ()
    if s == 1:
        # a one-rank model axis: its all-reduces are degenerate
        rules, forbidden, refused = (), (), (
            f"replication: no dimension {v} — with a model axis of one "
            f"rank the rank's block is the whole table",)
    else:
        _guard_dims(name, legit, [v])
    contract = CommContract(
        name=name, mesh_axes=_mesh_axes(mesh), rules=rules,
        forbidden_dims=forbidden, refused=refused, min_recorded=3,
        notes=f"V={v} B={b} d={d} rows={rows}")
    report = audit_trace(recorder.trace, contract)
    _hold_unchanged(report, on, off)
    return report


# ---------------------------------------------------------------------- #
# evaluation over the embeddings' row blocks
# ---------------------------------------------------------------------- #
EVAL_BATCH = 256    # eval.ranking.ranking_metrics' queries per batch
# the eval program's synthetic_fb15k scale: V = 290, a count no
# partition's padded vertex count (a multiple of 8) can equal
EVAL_SCALE = 0.02


def eval_contract(tr, name: str, mesh=None) -> CommContract:
    """The contract of ``tr.evaluate("test")`` on ``mesh`` (default the
    trainer's own): the encode's exchange once per partition and the
    ranking's four all-reduces per test batch and direction, on the
    ``model`` axis with exact bytes, and no output with the dimension
    ``V`` or ``S·rows``."""
    from repro_torch.sharding.embedding import ShardedTableLayout
    mesh = mesh or tr.mesh
    s = mesh.model
    d = int(tr.cfg.hidden_dim)
    v = int(tr.train_kg.num_entities)
    layout = ShardedTableLayout(v, s)
    padded = tr.pre.padded
    p, v_p = padded.num_partitions, padded.padded_vertices
    v_pad = -(-v_p // s) * s
    t = int(tr.splits["test"].num_edges)
    batches = -(-t // EVAL_BATCH)
    legit = [d, layout.rows_per_shard, v_p, v_pad, v_pad // s,
             padded.padded_edges, t, min(t, EVAL_BATCH), t % EVAL_BATCH,
             int(tr.train_kg.num_relations)]
    rules: List[CollectiveRule] = []
    forbidden = tuple(sorted({v, layout.padded_rows}))
    refused: Tuple[str, ...] = ()
    if s == 1:
        forbidden, refused = (), (
            f"replication: no dimension {v} — with a model axis of one "
            f"rank the rank's block is the whole table",)
    else:
        exchange = tr.cfg.gather_exchange or "psum_scatter"
        if exchange != "psum_scatter" or tr.cfg.table_dtype != "fp32" or \
                tr.kge_cfg.rgcn.feature_dim is not None:
            raise ValueError(
                f"{name}: the eval contract is derived for the fp32 table "
                f"on the default psum_scatter exchange")
        _guard_dims(name, legit, forbidden)
        rules = [
            CollectiveRule(
                "reduce-scatter", ("model",), min_count=p, max_count=p,
                expected_bytes=float(p * (v_pad // s) * d * 4),
                note="the encode's exchange, one a partition"),
            CollectiveRule(
                "all-gather", ("model",), min_count=p, max_count=p,
                expected_bytes=float(p * v_pad * d * 4),
                note="the encode's exchange, one a partition"),
            CollectiveRule(
                "all-reduce", ("model",), min_count=8 * batches,
                max_count=8 * batches,
                expected_bytes=4.0 * t * (4 * d + 4 + 2 * _COUNT_BYTES),
                note="head rows (f32), true score (f32) and the int64 "
                     "counts, per test batch and direction")]
    return CommContract(
        name=name, mesh_axes=_mesh_axes(mesh), rules=tuple(rules),
        forbidden_dims=forbidden, refused=refused, min_recorded=1,
        notes=f"V={v} d={d} P={p} V_p={v_p} T={t} rows="
              f"{layout.rows_per_shard}")


def audit_trainer_eval(tr, name: str = "eval[all-entities]") -> AuditReport:
    """Audit ``tr.evaluate("test")`` of an spmd trainer: run it under the
    recorder, then again without it (the metrics equal)."""
    if tr.mesh is None:
        raise ValueError(f"{name}: the trainer runs the simulated step; "
                         f"the audit needs spmd")

    def run(recorder=None):
        with recorder if recorder is not None else contextlib.nullcontext():
            metrics = tr.evaluate("test")
        return {k: torch.tensor(x, dtype=torch.float64)
                for k, x in metrics.items()}

    recorder = CommRecorder()
    on = run(recorder)
    off = run()
    report = audit_trace(recorder.trace, eval_contract(tr, name))
    _hold_unchanged(report, on, off)
    return report


def audit_eval_step(cfg: Optional[AuditConfig] = None,
                    device=None) -> AuditReport:
    """Build the spmd trainer at ``cfg``'s sizes (the default exchange, an
    fp32 table, ``EVAL_SCALE``'s graph) and audit its test evaluation."""
    cfg = cfg or AuditConfig()
    tr = _build_trainer(cfg, "psum_scatter", False, "fp32", device,
                        scale=EVAL_SCALE)
    try:
        return audit_trainer_eval(tr)
    finally:
        tr.close()


# ---------------------------------------------------------------------- #
# sharded top-k serve step
# ---------------------------------------------------------------------- #
def serve_contract(server, batch: int, k: int, name: str) -> CommContract:
    """No collective; no dimension ``V``; int8: no float32 output shaped
    like the code stack or the flat table."""
    s, rows = server.layout.num_shards, server.layout.rows_per_shard
    d, v = server.dim, server.num_entities
    k = min(k, v)
    quant = server.table_dtype == "int8"
    _guard_dims(name, [batch, d, k, rows, s * min(k, rows)], [v])
    return CommContract(
        name=name, mesh_axes=(), rules=(),   # any collective is a stray
        forbidden_dims=(v,),
        forbidden_f32_suffixes=(
            ((s, rows, d), (s * rows, d)) if quant else ()),
        notes=f"V={v} B={batch} k={k} S={s} — dense (B, N) scores must "
              f"never materialize"
              + (" and the fp32 table must stay per-block" if quant
                 else ""))


def audit_server(server, heads: np.ndarray, rels: np.ndarray, k: int, *,
                 filtered: bool = False,
                 name: Optional[str] = None) -> AuditReport:
    """Audit one ``server.topk_tails`` call (recorded, then again without
    the recorder: the top-k bitwise equal)."""
    name = name or ("serve[topk,int8]" if server.table_dtype == "int8"
                    else "serve[topk]")
    contract = serve_contract(server, len(heads), k, name)

    def run(recorder=None):
        with recorder if recorder is not None else contextlib.nullcontext():
            scores, tails = server.topk_tails(heads, rels, k,
                                              filtered=filtered)
        return {"scores": torch.from_numpy(scores),
                "tails": torch.from_numpy(tails)}

    recorder = CommRecorder()
    on = run(recorder)
    off = run()
    report = audit_trace(recorder.trace, contract)
    _hold_unchanged(report, on, off)
    return report


def audit_serve_step(cfg: Optional[AuditConfig] = None,
                     table_dtype: str = "fp32", device=None) -> AuditReport:
    """The sharded top-k serve program over a random ``(V, d)`` table, ``V
    = 25·S·d``, distmult, ``serve_batch`` queries, ``k = serve_k``."""
    from repro_torch.models.decoders import init_decoder_params
    from repro_torch.serving.kge import ShardedKGEServer

    cfg = cfg or AuditConfig()
    s, d, b, k = (cfg.num_table_shards, cfg.eval_dim, cfg.serve_batch,
                  cfg.serve_k)
    v = 25 * s * d
    rng = np.random.RandomState(cfg.seed)
    emb = rng.standard_normal((v, d)).astype(np.float32)
    dparams = init_decoder_params(np.random.default_rng(cfg.seed),
                                  "distmult", cfg.eval_relations, d)
    server = ShardedKGEServer(emb, dparams, "distmult", num_shards=s,
                              table_dtype=table_dtype, device=device)
    heads = rng.randint(0, v, size=b)
    rels = rng.randint(0, cfg.eval_relations, size=b)
    return audit_server(server, heads, rels, k)


# ---------------------------------------------------------------------- #
# runner
# ---------------------------------------------------------------------- #
def run_audit(cfg: Optional[AuditConfig] = None,
              programs: Sequence[str] = ("train", "rank", "eval", "serve"),
              exchanges: Optional[Sequence[str]] = None,
              dedups: Sequence[bool] = (False, True),
              device=None, log: Optional[Callable[[str], None]] = None
              ) -> List[AuditReport]:
    """Audit every requested program on this rank; one report per program
    (all ok ⇔ the port's communication contracts hold here). ``train``,
    ``rank`` and ``eval`` need the initialised process group (every rank
    runs the same sequence)."""
    from repro_torch.sharding.embedding import SPMD_EXCHANGES

    cfg = cfg or AuditConfig()
    exchanges = tuple(exchanges) if exchanges else SPMD_EXCHANGES
    reports: List[AuditReport] = []

    def note(msg):
        if log is not None:
            log(msg)

    if "train" in programs:
        for exchange in exchanges:
            for dedup in dedups:
                note(f"running train[{exchange}"
                     f"{',dedup' if dedup else ''}] ...")
                reports.append(audit_train_step(exchange, dedup, cfg,
                                                device=device))
        if "psum_scatter" in exchanges:
            # the int8 table on the default exchange: codes + f32 scales
            # on the wire, fp32 master gradients
            note("running train[psum_scatter,int8] ...")
            reports.append(audit_train_step(
                "psum_scatter", False, cfg, table_dtype="int8",
                device=device))
    if "rank" in programs:
        from repro_torch.device import resolve_device
        from repro_torch.launch.mesh import fit_spmd_mesh, make_process_mesh
        from repro_torch.launch.mesh import world_size
        dev = resolve_device(device)
        fit = fit_spmd_mesh(cfg.num_trainers, cfg.num_table_shards,
                            world_size())
        if fit is None:
            raise RuntimeError(
                f"the rank-step audit needs {cfg.num_table_shards} "
                f"model-axis ranks in a mesh of {world_size()} ranks")
        mesh = make_process_mesh(*fit, dev)
        for protocol in RANK_PROTOCOLS:
            note(f"running rank[{protocol}] ...")
            reports.append(audit_rank_step(protocol, mesh, cfg, dev))
    if "eval" in programs:
        note("running eval[all-entities] ...")
        reports.append(audit_eval_step(cfg, device=device))
    if "serve" in programs:
        note("running serve[topk] ...")
        reports.append(audit_serve_step(cfg, device=device))
        note("running serve[topk,int8] ...")
        reports.append(audit_serve_step(cfg, table_dtype="int8",
                                        device=device))
    return reports


def comm_audit_rows(reports: List[AuditReport]) -> List[Dict]:
    """JSON rows for a ``comm_audit`` benchmark section (the reference's
    ``BENCH_pipeline.json`` gate, ``benchmarks/run.py``)."""
    return [r.as_row() for r in reports]
