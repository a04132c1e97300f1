"""Launchers of the LLM scaffold, ported from ``repro.launch``: ``train``
(the P2P-DP training launcher, on one device or a DeviceMesh under
torchrun), ``serve`` (the deprecated path of the serving CLI), ``mesh``
(the production meshes and the card's peaks), ``dryrun`` (every step on
the production meshes over a fake process group, counted) and
``hillclimb`` (the dry-run's layout variants)."""
