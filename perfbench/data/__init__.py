"""The benchmark's frozen input generators (graph, agent data, delays, seeds)."""
