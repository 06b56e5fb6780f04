"""Batched LM serving, and the dense KGE link-prediction server (port of
``repro/serving/engine.py``).

``ServeEngine`` is batch-synchronous static batching: up to ``slots``
requests run together from position 0, with a fresh cache of ``max_seq``
positions per batch —
while a slot still has prompt tokens it consumes them (teacher forcing),
afterwards it consumes its own greedy token (argmax, the first index on
ties). One ``serve_step`` per position ``t`` (``pos = t`` for every slot,
and M-RoPE's three positions ``t`` too), under ``torch.inference_mode()``.
The encoder-decoder's ``encoder_out`` is zeros (``init_decode_cache``'s),
as in the reference, whose serving runs no encoder.
A request the ``max_seq`` horizon cuts off before it has produced
``max_new_tokens`` is ``truncated``, not ``done``.

``KGEServer`` answers ``(head, relation, ?)`` with the top-k tails over the
dense entity table through the ``kge_score`` and ``topk`` kernels.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import topk_padded
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.decoders import Decoder, get_decoder
from repro_torch.nn.transformer import ArchConfig, init_decode_cache


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray          # (P,) int token ids
    max_new_tokens: int = 16
    output: Optional[List[int]] = None
    done: bool = False          # produced its full max_new_tokens budget
    truncated: bool = False     # cut off by the engine's max_seq horizon


class ServeEngine:
    """Greedy decoding of ``requests`` with the LM ``params`` of ``cfg``
    (on the device they lie on)."""

    def __init__(self, cfg: ArchConfig, params, *, slots: int = 4,
                 max_seq: int = 256):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.device = params["embed"].device
        self._step = make_serve_step(cfg)

    def _run_batch(self, reqs: List[Request]) -> None:
        n = self.slots
        cache = init_decode_cache(self.cfg, n, self.max_seq,
                                  device=self.device,
                                  dtype=self.params["embed"].dtype)
        prompts = [np.asarray(r.prompt) for r in reqs] + \
            [np.zeros(1, np.int64)] * (n - len(reqs))
        plens = np.array([len(p) for p in prompts])
        budget = [r.max_new_tokens for r in reqs] + [0] * (n - len(reqs))
        horizon = int(min(self.max_seq - 1,
                          max(plens[i] + budget[i] for i in range(n))))
        for r in reqs:
            r.output = []

        cur = np.array([p[0] for p in prompts], np.int64)
        for t in range(horizon):
            tokens = torch.from_numpy(cur[:, None].copy())
            batch = {"tokens": tokens.to(self.device),
                     "pos": torch.full((n,), t, device=self.device)}
            if self.cfg.m_rope:
                batch["positions_3d"] = torch.full((n, 1, 3), t,
                                                   device=self.device)
            nxt, cache = self._step(self.params, cache, batch)
            nxt = nxt.cpu().numpy()
            for i, r in enumerate(reqs):
                if r.done:
                    continue
                if t + 1 < plens[i]:
                    cur[i] = prompts[i][t + 1]      # still in prompt
                else:
                    r.output.append(int(nxt[i]))
                    cur[i] = nxt[i]
                    if len(r.output) >= r.max_new_tokens:
                        r.done = True
            for i in range(len(reqs), n):
                cur[i] = 0
            if all(r.done for r in reqs):
                break
        for r in reqs:
            r.truncated = not r.done

    def run(self, requests: List[Request]) -> List[Request]:
        with torch.inference_mode():
            for lo in range(0, len(requests), self.slots):
                self._run_batch(requests[lo: lo + self.slots])
        return requests


class KGEServer:
    """Top-k tails of ``(head, relation, ?)`` over the dense ``(N, d)``
    entity table for any registered decoder. ``decoder_params`` is the
    decoder's parameter dictionary (numpy arrays or tensors); the
    candidate side of the query form is prepared once, at construction.
    Runs on ``device`` (default ``cuda``)."""

    def __init__(self, entity_emb, decoder_params,
                 decoder: Union[str, Decoder] = "distmult", *, device=None):
        self.device = resolve_device(device)
        self.decoder = get_decoder(decoder)
        self.emb = self._tensor(entity_emb)
        self.params = {k: self._tensor(v) for k, v in decoder_params.items()}
        self._prepared = self.decoder.prepare_candidates(self.params,
                                                         self.emb)

    def _tensor(self, x) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.array(x, np.float32))
        return x.to(self.device, torch.float32)

    def topk_tails(self, heads: np.ndarray, rels: np.ndarray,
                   k: int = 10) -> np.ndarray:
        """Top-k tail entity ids, ``(B, min(k, num_entities))``; ``k`` is
        clamped to the vocabulary and ties break toward the lowest entity
        id."""
        if k < 1:
            raise ValueError(f"k={k} must be >= 1")
        k = min(int(k), int(self.emb.shape[0]))
        h = torch.as_tensor(np.asarray(heads, np.int64)).to(self.device)
        r = torch.as_tensor(np.asarray(rels, np.int64)).to(self.device)
        scores = self.decoder.rank_scores(
            self.params, self.emb[h], r, self.emb, prepared=self._prepared)
        return topk_padded(scores, k)[1].cpu().numpy()
