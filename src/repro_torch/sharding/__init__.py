"""Mesh axis rules of the port (``repro.sharding``: the model side and
the simulator's), and the collectives of the sharded steps
(``spmd``)."""
