"""``phase_us.halo_exchange``: device us a slot of the sharded slot's halo
exchange (the border rows published with their residuals, quantized, the
ring shifts, the scatter into the halo rows): the prefix through
``halo_scatter`` minus the ``wake_sample`` prefix, from the engine's own
phase programs (``ShardedAsyncEngine.phase_program``), best of 3."""


def read(ctx):
    ph = ctx["phases"]
    if not ph or "wake_sample" not in ph or "halo_scatter" not in ph:
        return None
    return (ph["halo_scatter"] - ph["wake_sample"]) * 1e6
