"""The JAX package's examples on the port, one module each.

Each runs as ``python -m repro_torch.examples.<name>`` with the
reference example's flags (``--smoke``, ``--full`` and the others) plus
``--device`` (the card unless ``cpu`` is asked for), and its ``main(argv)``
returns what it printed as a dict: ``quickstart``,
``p2p_linear_classification``, ``sparse_p2p_scale``,
``async_p2p_simulation``, ``sharded_async_simulation`` (S shards stacked
on one device), ``movielens_recommendation`` and ``serve_batched``. The
two that call the reference's benches call the port's runners in
:mod:`repro_torch.bench`. ``decentralized_lm`` waits for ROADMAP A15d.
"""
