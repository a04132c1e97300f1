"""``round_updates_per_s``: ``updates_per_s`` under the name of the cells of
synchronous rounds, whose bound is their own (the same reading)."""

from perfbench.harness import reader

read = reader("updates_per_s")
