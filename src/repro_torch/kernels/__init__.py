"""The port's kernels: the packed sweeps (``packed``), the per-leaf
correction (``heloco_correct``) and outer update (``outer_update``), the
per-tensor int8 sweeps (``quantize``), their per-leaf entry points
(``ops``), and the attention forward of prefill (``flash_attention``).
Every kernel wrapper counts its launches; ``launch_counts`` reads them
all."""
from __future__ import annotations

from typing import Dict


def wrappers():
    """Every kernel wrapper of the port, in one tuple."""
    from repro_torch.kernels import (flash_attention, heloco_correct,
                                     outer_update, packed, quantize)
    return (packed.KERNEL_WRAPPERS + heloco_correct.KERNEL_WRAPPERS
            + outer_update.KERNEL_WRAPPERS + quantize.KERNEL_WRAPPERS
            + flash_attention.KERNEL_WRAPPERS)


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in wrappers()}


def reset_launch_counts():
    for fn in wrappers():
        fn.launches = 0
