"""Fleet distributed-training API (parity: fluid/incubate/fleet/):
``parameter_server`` (sync, async and GEO over the native parameter
server), ``collective`` (data parallel over ``torch.distributed``, with
LocalSGD), the role makers under ``base`` and ``utils``."""
