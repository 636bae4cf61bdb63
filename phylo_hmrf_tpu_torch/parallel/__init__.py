"""Meshes of shards and the multi-device E-steps: region sharding
(``sharding``) and row sharding with halo exchange (``halo``)."""
