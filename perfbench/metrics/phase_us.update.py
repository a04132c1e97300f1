"""``phase_us.update``: device us a slot of the update after the sampling:
the prefix through the fused kernel (``fused_row_update``), or through the
scatter on the unfused slot, minus the ``wake_sample`` prefix."""


def read(ctx):
    ph = ctx["phases"]
    if not ph or "wake_sample" not in ph:
        return None
    last = "fused_row_update" if "fused_row_update" in ph else "scatter"
    if last not in ph:
        return None
    return (ph[last] - ph["wake_sample"]) * 1e6
