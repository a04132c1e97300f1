"""``phase_us.shard_update``: device us a slot of the sharded slot's update
after the halo exchange: the prefix through ``fused_row_update`` (one launch
over the stacked slab, its inputs gathered at the woken rows) minus the
``halo_scatter`` prefix."""


def read(ctx):
    ph = ctx["phases"]
    if not ph or "halo_scatter" not in ph or "fused_row_update" not in ph:
        return None
    return (ph["fused_row_update"] - ph["halo_scatter"]) * 1e6
