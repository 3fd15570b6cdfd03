"""Sharding of the port: the JAX package's partitioning rules as DTensor placements."""
