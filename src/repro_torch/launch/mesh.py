"""Process meshes for the multi-process step (port of
``repro/launch/mesh.py`` and of the placement half of
``repro/sharding/rules.py``).

The reference drives a ``data`` × ``model`` device mesh from one process;
``torch.distributed`` runs one process per rank. A :class:`ProcessMesh`
lays the ranks of the default process group out row-major like the
reference's mesh: rank ``r`` sits at ``(data = r // model, model = r %
model)``. Its data group (the ranks of one model index) averages the
gradients; its model group (the ranks of one data index) holds the entity
table's row blocks side by side and exchanges gathered rows.

Importing this module starts no process group: the entry point
initialises the default group (``torch.distributed.init_process_group``)
and :func:`make_process_mesh` builds the subgroups on it, NCCL for
``cuda`` and gloo for ``cpu``.

The dry run (``launch/dryrun.py``) lays the reference's production meshes
(:data:`PRODUCTION_MESHES`) over a fake process group
(:func:`fake_process_group`, :func:`make_fake_mesh`) and divides its
counts by the H100's figures (:data:`PEAK_FLOPS_BF16`, :data:`HBM_BW`,
:data:`NET_BW`). The LM half of the reference's sharding rules is
``sharding/rules.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.data.pipeline import BatchShardings
from repro_torch.sharding.embedding import ModelAxis

REPLICATED = "replicated"
ROW_BLOCK = "row block on the model axis"


def backend_for(device: torch.device) -> str:
    """The collective backend of a device type: NCCL on the card, gloo on
    the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def world_size() -> int:
    """Ranks of the initialised default process group, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def fit_spmd_mesh(num_trainers: int, num_table_shards: int,
                  world: int) -> Optional[Tuple[int, int]]:
    """``(data, model)`` of the multi-process step over ``world`` ranks,
    or ``None`` when they cannot host it. The reference's rule: the model
    axis is exactly ``num_table_shards`` (one row block per model rank; a
    dense table means a 1-wide axis), the data axis the largest divisor of
    ``num_trainers`` that fits the rest. Every rank of a process group
    runs the step, so a mesh that leaves ranks out does not fit."""
    model = max(num_table_shards, 1)
    if model > world:
        return None
    data = max(d for d in range(1, world // model + 1)
               if num_trainers % d == 0)
    return (data, model) if data * model == world else None


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This rank's place on a ``data`` × ``model`` mesh of the default
    process group, with the groups of its two axes."""

    data: int
    model: int
    rank: int
    data_group: Any      # the ranks of this rank's model index
    model_group: Any     # the ranks of this rank's data index

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def model_axis(self) -> ModelAxis:
        return ModelAxis(self.model_group, self.model_index, self.model)

    def trainers(self, num_trainers: int) -> slice:
        """The trainers this rank runs: the data axis splits them into
        contiguous blocks, as the reference shards the trainer axis (the
        rule lives in ``BatchShardings.trainers``, which builds them)."""
        own = BatchShardings.of(self).trainers(num_trainers)
        return slice(own.start, own.stop)


def make_process_mesh(data: int, model: int,
                      device: torch.device) -> ProcessMesh:
    """The :class:`ProcessMesh` of the initialised default group, which
    must have ``data * model`` ranks. Every rank builds every subgroup, in
    the same order (``torch.distributed.new_group`` is collective)."""
    if not dist.is_initialized():
        raise ValueError("a process mesh needs an initialised process "
                         "group (torch.distributed.init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data * model != world:
        raise ValueError(f"a {data} x {model} mesh on {world} ranks")
    backend = backend_for(device)
    data_group = model_group = None
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)],
                           backend=backend)
        if rank % model == m:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)],
                           backend=backend)
        if rank // model == d:
            model_group = g
    return ProcessMesh(data, model, rank, data_group, model_group)


# ---------------------------------------------------------------------- #
# Placement (the reference's kge_param_specs / derive_opt_state_specs)
# ---------------------------------------------------------------------- #
def kge_param_specs(params: torch.nn.Module, model: int) -> Dict[str, str]:
    """Where each KGE parameter lives on the mesh: a stacked ``(S, rows,
    d)`` entity table is one row block per model rank (``S`` must be the
    model axis's size); every other parameter is replicated."""
    specs = {}
    for name, p in params.named_parameters():
        if name == "entity_embedding" and p.dim() == 3:
            if p.shape[0] != model:
                raise ValueError(f"entity table has {p.shape[0]} shards but "
                                 f"the model axis has {model} ranks")
            specs[name] = ROW_BLOCK
        else:
            specs[name] = REPLICATED
    return specs


def derive_opt_state_specs(opt_state, param_specs: Mapping[str, str]):
    """The placement of an optimizer state from its own structure: moment
    dictionaries (Adam's ``mu`` and ``nu``, SGD's momentum) are placed as
    their parameters, the step counter is replicated, absent moments stay
    ``None``."""
    def one(x):
        if x is None:
            return None
        if isinstance(x, Mapping):
            return {k: param_specs.get(k, REPLICATED) for k in x}
        return REPLICATED
    return type(opt_state)(*(one(x) for x in opt_state))


def row_block(whole: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """This rank's ``(1, rows, d)`` block (a view) of a whole ``(S, rows,
    d)`` stack."""
    i = mesh.model_index
    return whole[i:i + 1]


def gather_row_blocks(block: torch.Tensor, mesh: ProcessMesh
                      ) -> torch.Tensor:
    """The whole ``(S, rows, d)`` stack from every model rank's ``(1, rows,
    d)`` block, on every rank of the model group (``all_gather``): the
    inverse of :func:`row_block`. Collective over the model group."""
    whole = block.new_empty((mesh.model,) + tuple(block.shape[1:]))
    dist.all_gather_into_tensor(whole, block.contiguous(),
                                group=mesh.model_group)
    return whole


def place_row_blocks(model: torch.nn.Module, specs: Mapping[str, str],
                     mesh: ProcessMesh) -> None:
    """Keep only this rank's row block of every row-block parameter, in
    place: each rank starts from the same full parameters and holds its
    own ``(1, rows, d)`` block of the table from then on."""
    for name, spec in specs.items():
        if spec == ROW_BLOCK:
            block = row_block(getattr(model, name).detach(), mesh).clone()
            setattr(model, name, torch.nn.Parameter(block))


# ---------------------------------------------------------------------- #
# Production meshes on a fake process group (the dry run)
# ---------------------------------------------------------------------- #
# the reference's production meshes (repro/launch/mesh.py): one pod of
# 16 x 16 chips, and two pods with a leading "pod" axis
PRODUCTION_MESHES: Dict[str, Tuple[Tuple[int, ...], Tuple[str, ...]]] = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
}

# NVIDIA H100 80GB HBM3 (SXM) figures the dry run's roofline divides by;
# an analysis, not a measurement. Peak dense bf16 tensor-core rate and
# HBM3 rate from NVIDIA's H100 datasheet (the figures PERF.md's bounds
# use).
PEAK_FLOPS_BF16 = 989e12        # FLOP/s per GPU, NVIDIA H100 80GB HBM3
HBM_BW = 3.35e12                # bytes/s per GPU, NVIDIA H100 80GB HBM3
# The link a collective over a mesh axis is held to: a 16-wide axis
# leaves the 8-GPU NVLink domain of an HGX H100 node, so its slowest hop
# is the network, not NVLink 4's 450 GB/s a direction. The DGX H100
# datasheet gives each GPU one 400 Gb/s NDR InfiniBand port (ConnectX-7):
# 50e9 bytes/s a direction per NVIDIA H100 80GB HBM3.
NET_BW = 50e9                   # bytes/s per GPU, one direction


def production_mesh_shape(kind: str) -> Tuple[Tuple[int, ...],
                                               Tuple[str, ...]]:
    """``(shape, axis names)`` of the ``"single"`` or ``"multi"`` mesh."""
    if kind not in PRODUCTION_MESHES:
        raise ValueError(f"unknown mesh {kind!r}; known: "
                         f"{sorted(PRODUCTION_MESHES)}")
    return PRODUCTION_MESHES[kind]


@contextlib.contextmanager
def fake_process_group(world: int):
    """The default process group as ``world`` ranks of the fake backend
    (``torch.testing._internal.distributed.fake_pg``), this process rank
    0: its collectives return without sending anything, so a mesh of any
    size can be traced on one host with no card. Destroyed on exit; an
    initialised group already in place is refused."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_fake_mesh(shape: Sequence[int], names: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` with named dimensions over the ranks
    of the fake default group (:func:`fake_process_group` of
    ``prod(shape)`` ranks), laid out row-major as the reference's
    ``jax.make_mesh``. Its device type is ``cpu``: the dry run's shards
    are fake CPU tensors, whatever card the step would run on."""
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    if world_size() != n:
        raise ValueError(f"a {tuple(shape)} mesh on {world_size()} ranks")
    return DeviceMesh("cpu", torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))
