"""Checkpoints of the outer state (``ckpt.py``): save, restore, latest and
a background saver, interchangeable with the reference's files."""
from repro_torch.checkpoint.ckpt import (     # noqa: F401
    AsyncSaver, latest, restore, save,
)
