"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version:

* ``kge_score`` — candidate scoring in the decoders' query form
  (replaces ``repro/kernels/kge_score.py::kge_score``).
* ``topk`` — per-row top-k, ties to the lowest index
  (replaces ``repro/kernels/topk.py::topk_scores``).
* ``fused_gather`` — the sharded table's fused masked row gather
  (replaces ``repro/kernels/sharded_gather.py::fused_gather``).
* ``fused_dequant_gather`` — its int8 twin, the dequantization fused into
  the gather (replaces
  ``repro/kernels/sharded_gather.py::fused_dequant_gather``).
* ``scatter_add_onehot`` — their transpose, the masked scatter-add of row
  cotangents, deterministic without float atomics: the backward of the
  sharded table and of every training-path row gather (replaces
  ``repro/kernels/sharded_gather.py::scatter_add_onehot``).
* ``basis_message`` — the RGCN per-edge basis projection and coefficient
  mix (replaces ``repro/kernels/rgcn_message.py::basis_message``).
* ``segment_sum`` — the RGCN masked segment sum with degree counts,
  deterministic without float atomics (replaces
  ``repro/kernels/rgcn_message.py::segment_sum_onehot``).
* ``wkv_chunked`` — the chunked RWKV-6 WKV: every chunk's local terms at
  once, then a scan of the states, then the cross term (replaces
  ``repro/kernels/wkv_chunk.py::wkv_chunked``).
* ``wkv_chunked_backward`` — its gradient, the VJP of the sequential
  recurrence, a block per row walking back from state checkpoints (replaces
  no Pallas kernel: the reference takes ``jax.vjp`` of
  ``repro/kernels/ref.py::wkv_chunk_ref``).

``ops`` holds the public wrappers, ``ref`` the references under the JAX
package's names, ``_build`` the ``nvcc`` build and ``ctypes`` loader. A
kernel is built at its first launch, never at import.
"""
from repro_torch.kernels import ops, ref
from repro_torch.kernels.kge_score import (
    EPILOGUES, NORM_EPS, apply_epilogue, kge_score, kge_score_plain,
)
from repro_torch.kernels.ops import (
    dequant_sharded_gather, flat_gather_plan, fused_sharded_gather,
    gather_rows, kge_score_padded, masked_take, merge_topk,
    quantized_sharded_gather, rgcn_message_basis, topk_padded,
    wkv_chunked_op,
)
from repro_torch.kernels.rgcn_message import (
    basis_message, basis_message_plain, segment_sum, segment_sum_plain,
)
from repro_torch.kernels.sharded_gather import (
    fused_dequant_gather, fused_dequant_gather_plain, fused_gather,
    fused_gather_plain, scatter_add_onehot, scatter_add_onehot_plain,
)
from repro_torch.kernels.topk import topk_plain, topk_scores
from repro_torch.kernels.wkv_chunk import (
    wkv_chunked, wkv_chunked_backward, wkv_chunked_backward_plain,
    wkv_chunked_plain,
)

# every kernel wrapper of the port; each counts its launches in
# ``wrapper.launches``
KERNELS = {"kge_score": kge_score, "topk": topk_scores,
           "fused_gather": fused_gather,
           "fused_dequant_gather": fused_dequant_gather,
           "basis_message": basis_message,
           "segment_sum": segment_sum,
           "scatter_add_onehot": scatter_add_onehot,
           "wkv_chunked": wkv_chunked,
           "wkv_chunked_backward": wkv_chunked_backward}

__all__ = ["ops", "ref", "EPILOGUES", "NORM_EPS", "KERNELS",
           "apply_epilogue", "kge_score", "kge_score_plain",
           "kge_score_padded", "topk_scores", "topk_plain", "topk_padded",
           "merge_topk", "fused_gather", "fused_gather_plain",
           "fused_dequant_gather", "fused_dequant_gather_plain",
           "dequant_sharded_gather", "quantized_sharded_gather",
           "flat_gather_plan", "fused_sharded_gather", "gather_rows",
           "masked_take", "scatter_add_onehot", "scatter_add_onehot_plain",
           "basis_message",
           "basis_message_plain", "segment_sum", "segment_sum_plain",
           "rgcn_message_basis", "wkv_chunked", "wkv_chunked_plain",
           "wkv_chunked_backward", "wkv_chunked_backward_plain",
           "wkv_chunked_op"]
