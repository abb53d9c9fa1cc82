"""Workload families: arrival lanes, queues, the scenario library and
the per-family board."""
