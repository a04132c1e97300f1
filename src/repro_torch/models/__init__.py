"""Model families of the LLM scaffold, ported from ``repro.models``.

Every family is ported, for serving and training: the zamba2 hybrid
(``hybrid``: Mamba2 blocks through the ``ssm_chunk`` kernel on the card,
one shared attention + SwiGLU block, with ``ssm``), the decoder-only
transformer (``transformer``: dense, MoE through ``moe``, VLM), the
enc-dec transformer (``encdec``) and the recurrent xLSTM (``xlstm_stack``
over the mLSTM and sLSTM blocks of ``xlstm``), their ``layers`` and the
``registry`` (``build_model``).
"""

from repro_torch.models.registry import ModelBundle, build_model

__all__ = ["ModelBundle", "build_model"]
