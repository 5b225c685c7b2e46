"""Event-driven virtual-clock simulator: the port of
``repro/async_engine/simulator.py``. A dispatched round is stored and
computed in-line when its virtual return event pops."""
from __future__ import annotations

from typing import Dict

from repro_torch.async_engine.engine import (
    EngineBase, RoundResult, RoundTask, Worker,
)


class AsyncSimulator(EngineBase):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._pending: Dict[int, RoundTask] = {}

    def _submit(self, task: RoundTask):
        """Lazy execution: park the round until its return event fires."""
        self._pending[task.task_id] = task

    def _obtain(self, w: Worker) -> RoundResult:
        return self._execute(self._pending.pop(w.pending_task_id))
