"""Model families of the LLM scaffold, ported from ``repro.models``.

Ported so far: the zamba2 hybrid for serving (``hybrid``: Mamba2 blocks
through the ``ssm_chunk`` kernel on the card, one shared attention +
SwiGLU block), its ``layers``, ``attention`` and ``ssm``, and the
``registry`` (``build_model``). The other families and training are
queued in ``ROADMAP.md`` (A15b-A15d).
"""
