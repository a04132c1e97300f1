"""Launchers of the LLM scaffold, ported from ``repro.launch``: ``train``
(the P2P-DP training launcher) and ``serve`` (the deprecated path of the
serving CLI). The mesh, dry-run and hill-climb launchers wait for ROADMAP
A15d."""
