"""Model families of the LLM scaffold, ported from ``repro.models``.

Every family is ported, for serving and training: the zamba2 hybrid
(``hybrid``: Mamba2 blocks through the ``ssm_chunk`` kernel on the card,
one shared attention + SwiGLU block, with ``ssm``), the decoder-only
transformer (``transformer``: dense, MoE through ``moe``, VLM), the
enc-dec transformer (``encdec``) and the recurrent xLSTM (``xlstm_stack``
over the mLSTM and sLSTM blocks of ``xlstm``), their ``layers`` and the
``registry`` (``build_model``), and the compiled decode
(``decode_graph``: every family's decode step captured once as a CUDA
graph and replayed at every position).
"""

from repro_torch.models.decode_graph import DecodeGraph
from repro_torch.models.registry import ModelBundle, build_model

__all__ = ["DecodeGraph", "ModelBundle", "build_model"]
