"""Slab sharding of the port: ``sharding`` (the shards) and ``routing``
(owner-slab routing, kernel B12)."""
