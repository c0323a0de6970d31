"""Sharding rules of the port (reference: ``repro.sharding``)."""
