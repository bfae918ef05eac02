"""Mesh axis rules of the port (the simulator's part of
``repro.sharding``)."""
