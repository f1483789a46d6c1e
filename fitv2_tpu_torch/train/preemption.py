"""Preemption-safe exit for the training loop, on one process.

Counterpart of fitv2_tpu/train/preemption.py: the first SIGTERM/SIGINT sets
a flag (and puts the original handlers back, so a second signal acts at
once); the loop finishes its step, writes a checkpoint at that step and
returns. The JAX guard all-gathers the flag across processes; the port
runs on one process, and that agreement waits for its multi-device slice.
"""

from __future__ import annotations

import logging
import signal

logger = logging.getLogger('fitv2_tpu_torch.preemption')


class PreemptionGuard:
    def __init__(self, enabled: bool = True):
        import torch.distributed as dist
        if enabled and dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise NotImplementedError(
                'the preemption guard is single-process; agreeing on the '
                'flag across processes is not ported (ROADMAP.md §1, slice 9)')
        self.enabled = enabled
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
        """Poll once per train step: whether a signal has arrived."""
        return self.enabled and self.sig is not None
