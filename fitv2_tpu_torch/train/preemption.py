"""Preemption-safe exit for the training loop.

Counterpart of fitv2_tpu/train/preemption.py: the first SIGTERM/SIGINT sets
a flag (and puts the original handlers back, so a second signal acts at
once); the loop finishes its step, writes a checkpoint at that step and
returns. Across processes the flag is agreed every ``sync_every`` steps
(a max over the processes; every process polls at the same steps, so
the collectives line up): a signal on any process stops every process
after the same step, within ``sync_every`` steps of the signal. A
per-step agreement would hold the host at every step.
"""

from __future__ import annotations

import logging
import signal

import torch
import torch.distributed as dist

from fitv2_tpu_torch.parallel.mesh import collective_device, process_count

logger = logging.getLogger('fitv2_tpu_torch.preemption')


class PreemptionGuard:
    def __init__(self, enabled: bool = True, sync_every: int = 16):
        self.enabled = enabled
        self.sync_every = max(1, int(sync_every))
        self.sig = None
        self._installed = {}
        if not enabled:
            return
        try:
            for s in (signal.SIGTERM, signal.SIGINT):
                self._installed[s] = signal.signal(s, self._on_signal)
        except ValueError:  # not the main thread: no handlers, flag only
            self.restore()

    def _on_signal(self, signum, frame):
        self.sig = signum
        self.restore()  # a second signal gets the original handler
        logger.warning(
            'signal %d: writing a checkpoint after the current step, then '
            'exiting (send again to exit now)', signum)

    def restore(self) -> None:
        """Put the original signal handlers back (idempotent)."""
        for s, h in list(self._installed.items()):
            try:
                signal.signal(s, h)
            except (ValueError, OSError):
                pass
        self._installed.clear()

    def should_stop(self, step: int) -> bool:
        """Poll once per train step: whether a signal has arrived; data
        parallel, on any process, agreed at the steps that ``sync_every``
        divides (every process must poll at every step)."""
        if not self.enabled:
            return False
        if process_count() == 1:
            return self.sig is not None
        if step % self.sync_every:
            return False
        flag = torch.tensor([int(self.sig is not None)],
                            device=collective_device())
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())
