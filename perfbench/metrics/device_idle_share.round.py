"""``device_idle_share.round``: ``device_idle_share`` under the name of the
cells of synchronous rounds, whose end-to-end metric is
``round_updates_per_s`` (the same reading)."""

from perfbench.harness import reader

read = reader("device_idle_share")
