"""Input pipelines (port of the full-graph part of
``repro/data/pipeline.py``).

* ``FullGraphPipeline`` — the full-edge-batch mode (the paper's FB15k-237
  configuration): every padded partition stacked on the trainer axis,
  copied to the device ONCE and reused every epoch. The batch is
  epoch-invariant; per-epoch randomness lives in the trainers'
  generators.
* ``eval_partition_batches`` — one partition slice of the padded batch at
  a time, for the streamed evaluation encode.

The mini-batch pipelines (serial and async) are not ported yet
(``repro_torch.roadmap``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import torch

from repro_torch.core.expansion import PaddedPartitionBatch


@dataclasses.dataclass
class PipelineStats:
    """Per-epoch host-side timing of one pipeline run (the reference's
    contract): ``warmup_s`` is the wait for the first batch,
    ``host_build_s`` / ``exposed_wait_s`` cover the steady state after
    it."""

    host_build_s: float = 0.0    # build time of consumed steady-state batches
    exposed_wait_s: float = 0.0  # construction time on the critical path
    warmup_s: float = 0.0        # wait for the first batch (pipeline fill)
    num_batches: int = 0

    def overlap_fraction(self) -> float:
        """Fraction of steady-state host build time hidden behind the
        device step."""
        if self.host_build_s <= 0.0:
            return 0.0
        return max(0.0, 1.0 - self.exposed_wait_s / self.host_build_s)


def padded_fields(padded: PaddedPartitionBatch) -> Dict:
    """The padded batch as a field-name dict of numpy arrays."""
    return {f.name: getattr(padded, f.name)
            for f in dataclasses.fields(padded)}


# per-partition scalars the host reads (the negative sampler's draw limit):
# they stay host tensors, so reading one never waits for the device
HOST_FIELDS = ("num_core_vertices", "num_core_edges")


def to_device(arrays: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """Host numpy arrays → tensors on ``device`` (copied), except the
    ``HOST_FIELDS``, which stay on the host."""
    return {k: torch.as_tensor(v).to("cpu" if k in HOST_FIELDS else device,
                                     copy=True)
            for k, v in arrays.items()}


class FullGraphPipeline:
    """One full-edge batch per epoch, resident on ``device``."""

    def __init__(self, padded: PaddedPartitionBatch, device: torch.device):
        self.device = torch.device(device)
        self._host = padded_fields(padded)
        self._device: Optional[Dict[str, torch.Tensor]] = None
        self._stats = PipelineStats()

    @property
    def last_stats(self) -> PipelineStats:
        return self._stats

    def device_batches(self, epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
        """The same batch on the device, copied at the first call only."""
        if self._device is None:
            self._device = to_device(self._host, self.device)
        self._stats = PipelineStats(num_batches=1)
        yield self._device


def eval_partition_batches(padded: PaddedPartitionBatch,
                           device: torch.device
                           ) -> Iterator[Dict[str, torch.Tensor]]:
    """Per-partition device batches for the evaluation encode: one
    partition slice of the padded batch at a time, so the encoder streams
    partitions instead of one full-graph mega-partition."""
    fields = padded_fields(padded)
    for i in range(padded.num_partitions):
        yield to_device({k: v[i] for k, v in fields.items()}, device)
