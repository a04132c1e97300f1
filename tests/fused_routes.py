"""A test helper shared by ``test_torch_fused_src.py`` and
``test_torch_cuda.py``: the fused update's row-gathered route."""

import dataclasses


def row_gathered(upd):
    """The same update rule, handing the kernel row-gathered inputs: the
    engine's whole tables and ``src`` become ``table[src]`` and
    ``src=None``, with the constants gathered per slot (the contract the
    engine's fused route had)."""

    class RowGathered(type(upd)):
        def apply_fused(self, Theta_slab, rows, valid, generator, state, cols, w, *a,
                        consts=None, src=None, **kw):
            assert src is not None  # the engine passes the index
            return super().apply_fused(Theta_slab, rows, valid, generator, state, cols[src],
                                       w[src], *a, **kw)

    return RowGathered(**{f.name: getattr(upd, f.name) for f in dataclasses.fields(upd)})
