"""Hand-written CUDA kernels for Hopper (sm_90a), one per Pallas TPU kernel
ported so far, each beside its plain PyTorch version:

* ``sparse_mix``       — padded-neighbour mixing (``csrc/sparse_mix.cu``);
* ``fused_row_update`` — the fused woken-row Eq. 4 super-tick
  (``csrc/fused_row_update.cu``);
* ``graph_mix``        — dense ``A @ Theta`` in full float32
  (``csrc/graph_mix.cu``);
* ``dp_clip_noise``    — per-example L2 clip, mean and noise of the DP
  gradient aggregation (``csrc/dp_clip_noise.cu``; reached only through
  ``ops.dp_clip_noise``, as in the reference);
* ``ssm_chunk``        — Mamba2's intra-chunk SSD, the chunk output and
  chunk-end state (``csrc/ssm_chunk.cu``; the Mamba2 block of
  ``repro_torch.models.ssm`` launches it in every prefill on the card).

``ops`` holds the dispatching wrappers and the launch counts, ``ref`` the
plain versions under the reference's names, ``_build`` the nvcc build.
Nothing here imports a compiler or touches the card at import time.
"""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
