"""Deprecated location — the serving CLI lives at ``repro_torch.serve``.

Port of the reference's ``repro/launch/serve.py`` stub: the serving tier
is the personalized peer-to-peer inference path,

    PYTHONPATH=src python -m repro_torch.serve --checkpoint-dir ckpts
    PYTHONPATH=src python -m repro_torch.serve --live --n 20000 --shards 8

and this module forwards ``main`` to :mod:`repro_torch.serve.__main__`
with a DeprecationWarning so the old entry point keeps resolving.
"""

from __future__ import annotations

import warnings


def main(argv=None) -> int:
    """Forward to ``python -m repro_torch.serve`` (deprecated path)."""
    warnings.warn(
        "repro_torch.launch.serve is deprecated; use `python -m repro_torch.serve` "
        "(repro_torch.serve.__main__.main) instead",
        DeprecationWarning,
        stacklevel=2,
    )
    from repro_torch.serve.__main__ import main as serve_main

    return serve_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
