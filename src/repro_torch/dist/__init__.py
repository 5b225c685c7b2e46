"""Distribution layer: sharding rules (specs for params, batches and KV
caches) and the train/prefill/decode/outer-exchange steps, for the
production meshes and the one-card mesh of ``repro_torch.launch.mesh``.
Port of ``repro/dist``."""
from repro_torch.dist import sharding, steps  # noqa: F401

__all__ = ["sharding", "steps"]
