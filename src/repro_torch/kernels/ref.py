"""Plain PyTorch versions of the ported kernels, under the reference's
``repro.kernels.ref`` names. Each is the kernel module's own plain
version; ``fused_row_update_ref`` updates ``theta`` in place like the
kernel (the reference's returns a new slab)."""

from __future__ import annotations

from repro_torch.kernels.dp_clip_noise import dp_clip_noise_plain as dp_clip_noise_ref
from repro_torch.kernels.fused_row_update import fused_row_update_plain as fused_row_update_ref
from repro_torch.kernels.graph_mix import graph_mix_plain as graph_mix_ref
from repro_torch.kernels.sparse_mix import sparse_mix_plain as sparse_mix_ref
from repro_torch.kernels.ssm_chunk import ssm_chunk_plain as ssm_chunk_ref

__all__ = ["dp_clip_noise_ref", "fused_row_update_ref", "graph_mix_ref", "sparse_mix_ref",
           "ssm_chunk_ref"]
