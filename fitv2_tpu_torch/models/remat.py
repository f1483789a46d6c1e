"""The selective remat policies, and 'dots_offload': the products that
'dots' saves wait in pinned host memory between the forward and the
backward.

Counterpart of the remat policies of fitv2_tpu/models/fit.py. 'dots' and
'dots_all' are torch's selective activation checkpointing over
``REMAT_SAVED_OPS``. 'dots_offload' is JAX's
``offload_dot_with_no_batch_dims('device', 'pinned_host')``: it saves the
ops 'dots' saves (mm and addmm, the products with no batch dimension) and
computes exactly what 'dots' computes; only where the saved outputs wait
differs. ``OffloadSession`` is the ``context_fn`` of
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` for one
pass through a stack of blocks: each call opens an ``OffloadStore`` for
one block and returns its two dispatch modes, ``_SaveToHost`` for the
forward and ``_LoadFromHost`` for the recompute. torch's own selective
checkpointing keeps its outputs in a dict on the device, out of reach of
``saved_tensors_hooks``; these modes keep them in the store instead.

On the card each saved output is copied to a pinned host buffer on a side
stream (device -> host) after an event on the compute stream, and the
device tensor is not reused before that copy is done (``record_stream``).
A block's forward is the faster of the two: before block i's forward the
compute stream waits for block i - ``FORWARD_LAG``'s copies, so that the
outputs that wait on the card for their copy stay a few blocks' worth.
When block i's recompute starts, block i's outputs (unless already on
their way) and block i-1's are copied back on a second side stream (host
-> device), and the compute stream waits for a tensor's copy only where
the recompute reads it. The first block of the backward (the last of the
forward) cannot be fetched ahead: its copy back stalls the recompute
that reads it. The host buffers come from ``PINNED``, a pool that keeps
them across steps. On the CPU the store holds a copy of each output
(another storage), and no stream is involved. Any other device raises:
nothing keeps the outputs where they were made.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten
# The ops whose outputs each selective remat policy saves; every other op
# of a block is recomputed in the backward pass. 'dots' is JAX's
# dots_with_no_batch_dims_saveable: the 2-D products (qkv, proj, fc1/fc2,
# adaLN and its LoRA). 'dots_all' is dots_saveable: the batched products
# too. A kernel launched through ctypes is no aten op, so its autograd
# Function reruns in the recompute, as a pallas_call does under JAX's
# policies. 'dots_offload' saves what 'dots' saves, in host memory.
REMAT_SAVED_OPS = {
    'dots': (_aten.mm.default, _aten.addmm.default),
    'dots_all': (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                 _aten.baddbmm.default),
}
_OFFLOADED = frozenset(REMAT_SAVED_OPS['dots'])
# blocks whose copies to the host may still run when a block's forward
# starts
FORWARD_LAG = 2

# what the stores moved since the last reset, in the process (as the
# kernels' launch counters): bytes and copies each way (device -> host in
# the forward, host -> device for the recompute)
counts = {'d2h_bytes': 0, 'h2d_bytes': 0, 'd2h_copies': 0, 'h2d_copies': 0}


def reset_counts() -> None:
    for key in counts:
        counts[key] = 0


_MISMATCH = ('This can happen if the operations in the checkpointed region '
             'are nondeterministic or depend on global state that changed '
             'between forward and backward.')


class PinnedPool:
    """Page-locked host buffers, kept across steps: a buffer given back
    serves the next request of its exact size, after the copy that last
    read it (its event) is done. New buffers are carved from the first
    pinned slab with room, slabs of at least ``SLAB_BYTES`` (torch rounds
    a pinned allocation up to a power of two, so one slab serves many
    buffers). Nothing is unpinned before ``clear()``."""

    ALIGN = 512
    SLAB_BYTES = 1 << 30

    def __init__(self):
        self.reserved = 0  # pinned bytes taken from torch
        self._free: Dict[int, list] = defaultdict(list)
        self._slabs: List[list] = []  # [slab, bytes carved from it]

    def take(self, nbytes: int, stream: torch.cuda.Stream) -> torch.Tensor:
        """A uint8 buffer of ``nbytes``; ``stream`` waits until the copy
        that last read it is done."""
        free = self._free.get(nbytes)
        if free:
            buf, read = free.pop()
            stream.wait_event(read)
            return buf
        size = -(-nbytes // self.ALIGN) * self.ALIGN
        slab = next((s for s in self._slabs if s[1] + size <= s[0].numel()),
                    None)
        if slab is None:
            want = max(self.SLAB_BYTES, size)
            try:
                slab = [torch.empty(want, dtype=torch.uint8,
                                    pin_memory=True), 0]
            except RuntimeError as err:
                raise MemoryError(
                    f'dots_offload: pinning {want} bytes of host memory '
                    f'failed ({self.reserved} bytes pinned before)') from err
            self._slabs.append(slab)
            self.reserved += want
        buf = slab[0][slab[1]:slab[1] + nbytes]
        slab[1] += size
        return buf

    def give(self, buf: torch.Tensor, read: torch.cuda.Event) -> None:
        """``buf`` is free once ``read`` (the copy from it) is done."""
        self._free[buf.numel()].append((buf, read))

    def clear(self) -> None:
        """Drop every buffer (the caller makes sure none is in use)."""
        self._free.clear()
        self._slabs.clear()
        self.reserved = 0


# the process's pool: every model and step takes its buffers from it
PINNED = PinnedPool()
_streams: Dict[int, Tuple[torch.cuda.Stream, torch.cuda.Stream]] = {}


def _copy_streams(device: torch.device
                 ) -> Tuple[torch.cuda.Stream, torch.cuda.Stream]:
    """The (device -> host, host -> device) side streams of a card."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index not in _streams:
        _streams[index] = (torch.cuda.Stream(index), torch.cuda.Stream(index))
    return _streams[index]


class _Entry:
    """One saved output: its host copy, then its tensor back on the
    card."""
    __slots__ = ('host', 'device', 'copied', 'value', 'ready')

    def __init__(self, host, device, copied=None):
        self.host, self.device, self.copied = host, device, copied
        self.value = self.ready = None


_CONSUMED = object()


class OffloadStore:
    """The saved products of one checkpointed block, keyed by (op, call
    index) as torch's selective checkpointing keys them; ``len`` counts
    the entries that still hold an output."""

    def __init__(self, session: 'OffloadSession', index: int):
        self.session, self.index = session, index
        self.entries: Dict[tuple, object] = {}
        self.fetched = False
        self.copied: Optional[Tuple[torch.device, torch.cuda.Event]] = None
        self._written: List[Tuple[torch.Tensor, int]] = []

    def __len__(self) -> int:
        return sum(e is not _CONSUMED for e in self.entries.values())

    def save(self, key: tuple, out: torch.Tensor) -> None:
        nbytes = out.numel() * out.element_size()
        if out.device.type == 'cpu':
            entry = _Entry(out.detach().clone(), out.device)
        elif out.device.type == 'cuda':
            if not out.is_contiguous():
                raise NotImplementedError(
                    f'dots_offload: {key[0]} gave a non-contiguous output')
            d2h, _ = _copy_streams(out.device)
            host = PINNED.take(nbytes, d2h).view(out.dtype).view(out.shape)
            d2h.wait_stream(torch.cuda.current_stream(out.device))
            with torch.cuda.stream(d2h):
                host.copy_(out.detach(), non_blocking=True)
            out.record_stream(d2h)  # its memory waits for the copy
            copied = torch.cuda.Event()
            copied.record(d2h)
            entry = _Entry(host, out.device, copied)
            self.copied = (out.device, copied)
        else:
            raise NotImplementedError(
                f'dots_offload keeps no outputs of {out.device}: it offloads '
                "from 'cuda' to pinned host memory, or copies on the 'cpu'")
        self.entries[key] = entry
        self._written.append((out, out._version))
        counts['d2h_bytes'] += nbytes
        counts['d2h_copies'] += 1

    def wait_copied(self) -> None:
        """The compute stream waits until the copies to the host are
        done."""
        if self.copied is not None:
            device, event = self.copied
            torch.cuda.current_stream(device).wait_event(event)

    def close_forward(self) -> None:
        """The block's forward is done: no saved output may have changed
        since it was copied."""
        written, self._written = self._written, []
        if any(t._version != v for t, v in written):
            raise RuntimeError('Tensor cached during selective activation '
                               'checkpoint has been mutated')

    def fetch(self) -> None:
        """Start the copies back to the card (once)."""
        if self.fetched:
            return
        self.fetched = True
        entries = [e for e in self.entries.values() if e is not _CONSUMED]
        for entry in entries:
            host = entry.host
            if entry.device.type == 'cuda':
                _, h2d = _copy_streams(entry.device)
                # allocated on the compute stream, so the copy waits until
                # the compute stream is done with that memory
                entry.value = torch.empty(host.shape, dtype=host.dtype,
                                          device=entry.device)
                h2d.wait_stream(torch.cuda.current_stream(entry.device))
                h2d.wait_event(entry.copied)
                with torch.cuda.stream(h2d):
                    entry.value.copy_(host, non_blocking=True)
                entry.value.record_stream(h2d)  # if it is never taken
                entry.ready = torch.cuda.Event()
                entry.ready.record(h2d)
                PINNED.give(host.view(-1).view(torch.uint8), entry.ready)
            else:
                entry.value = host
            entry.host = None
            counts['h2d_bytes'] += host.numel() * host.element_size()
            counts['h2d_copies'] += 1

    def take(self, key: tuple) -> torch.Tensor:
        entry = self.entries.get(key)
        if entry is None:
            raise RuntimeError(
                f'{key[0]} call {key[1]} encountered during backward but '
                f'not found in storage. {_MISMATCH}')
        if entry is _CONSUMED:
            raise RuntimeError(
                'Trying to backward an extra time. You are only allowed to '
                'backward once on any region computed under selective '
                'activation checkpoint.')
        self.entries[key] = _CONSUMED
        if entry.ready is not None:
            torch.cuda.current_stream(entry.device).wait_event(entry.ready)
        return entry.value


class _SaveToHost(TorchDispatchMode):
    """The forward's mode: runs every op, and stores the outputs of the
    ops that 'dots' saves."""

    def __init__(self, store: OffloadStore):
        super().__init__()
        self.store = store
        self.calls: Dict[object, int] = defaultdict(int)

    def __enter__(self):
        self.store.session.begin_forward(self.store)
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _OFFLOADED:
            self.store.save((func, self.calls[func]), out)
            self.calls[func] += 1
        return out

    def __exit__(self, exc_type, exc_value, traceback):
        self.store.close_forward()
        return super().__exit__(exc_type, exc_value, traceback)


class _LoadFromHost(TorchDispatchMode):
    """The recompute's mode: hands back the stored outputs in the
    forward's order, and runs every other op."""

    def __init__(self, store: OffloadStore):
        super().__init__()
        self.store = store
        self.calls: Dict[object, int] = defaultdict(int)

    def __enter__(self):
        self.calls.clear()
        self.store.session.begin_recompute(self.store)
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in _OFFLOADED:
            return func(*args, **(kwargs or {}))
        key = (func, self.calls[func])
        self.calls[func] += 1
        return self.store.take(key)


class OffloadSession:
    """The host offload of one pass through a stack of checkpointed
    blocks; call it as ``checkpoint``'s ``context_fn`` (once a block, in
    the forward's order)."""

    def __init__(self):
        self.stores: List[OffloadStore] = []

    def __call__(self) -> Tuple[_SaveToHost, _LoadFromHost]:
        store = OffloadStore(self, len(self.stores))
        self.stores.append(store)
        return _SaveToHost(store), _LoadFromHost(store)

    def begin_forward(self, store: OffloadStore) -> None:
        """Block i's forward starts: the compute stream waits for block
        i - FORWARD_LAG's copies to the host."""
        if store.index >= FORWARD_LAG:
            self.stores[store.index - FORWARD_LAG].wait_copied()

    def begin_recompute(self, store: OffloadStore) -> None:
        """Block i's recompute starts: fetch its outputs (unless they are
        on their way) and start block i-1's, which the backward needs
        next."""
        store.fetch()
        if store.index > 0:
            self.stores[store.index - 1].fetch()
