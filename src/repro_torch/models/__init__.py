"""Model families of the LLM scaffold, ported from ``repro.models``.

Ported so far: every family built on ``attention``: the zamba2 hybrid
(``hybrid``: Mamba2 blocks through the ``ssm_chunk`` kernel on the card,
one shared attention + SwiGLU block, with ``ssm``), the decoder-only
transformer (``transformer``: dense, MoE through ``moe``, VLM) and the
enc-dec transformer (``encdec``), their ``layers`` and the ``registry``
(``build_model``), for serving and training. The recurrent xLSTM family
is queued in ``ROADMAP.md`` (A15c-ii).
"""

from repro_torch.models.registry import ModelBundle, build_model

__all__ = ["ModelBundle", "build_model"]
