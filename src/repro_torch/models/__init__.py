"""Model families of the LLM scaffold, ported from ``repro.models``.

Ported so far: the zamba2 hybrid for serving and training (``hybrid``:
Mamba2 blocks through the ``ssm_chunk`` kernel on the card, one shared
attention + SwiGLU block, the loss with remat), its ``layers``,
``attention`` and ``ssm``, and the ``registry`` (``build_model``). The
other families are queued in ``ROADMAP.md`` (A15c).
"""

from repro_torch.models.registry import ModelBundle, build_model

__all__ = ["ModelBundle", "build_model"]
