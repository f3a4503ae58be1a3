"""Sharding of the port: the per-architecture placement policy
(``policy``) and the activation-sharding context (``ctx``)."""
