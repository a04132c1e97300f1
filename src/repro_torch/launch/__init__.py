"""Launchers of the LLM scaffold, ported from ``repro.launch``: ``train``
(the P2P-DP training launcher). The mesh, dry-run and hill-climb launchers
wait for ROADMAP A15d."""
