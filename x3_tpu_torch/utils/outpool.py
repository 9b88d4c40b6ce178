"""Recycled host pages for multifile.decode_streams' large int16 outputs.

An output of THRESHOLD_BYTES or more comes from POOL, not from np.empty.
glibc serves every allocation of 32 MiB or more (DEFAULT_MMAP_THRESHOLD_MAX
on 64-bit, past which its mmap threshold never rises) with a mapping of its
own and unmaps it on free, so such an np.empty output is new memory every
call: each page faults and is zeroed by the kernel on its first write, and a
copy into it runs at about half the rate of one into pages already touched.
Below the threshold glibc recycles freed memory itself, and np.empty stays.

A block is an anonymous private mapping (mmap).  The output is
np.frombuffer(mapping, np.int16, n): a writable, C-contiguous int16 array
of np.empty's dtype, shape and writability, whose base is a buffer of the
mapping.  numpy makes that output the base of every view and reshape of it
(the chain stops at the first base that is not an array), and a memoryview
or torch.from_numpy of it holds it too, so the output lives as long as any
of them.  Nothing here needs a Python type that exports a buffer itself.

The reuse rule: a weakref.finalize on the output gives its mapping back to
the pool once the output is gone, that is once no array, view or buffer of
it remains, on whichever thread dropped the last of them.  A mapping the
caller can still reach is never handed out again.  A request takes the
smallest free mapping that holds it and is at most twice its size, else it
maps a new one.  The recycled pages hold an earlier output's samples:
decode_streams writes every sample of its outputs before it returns them,
and a call that raises returns none.  The pool never closes a mapping: the
dying output still holds its buffer when its finalizer runs, so a mapping
the pool lets go is unmapped when its last buffer is released.

The cap: the pool keeps free mappings only up to the bytes that the most
recent take took from it, and lets go at once of one given back beyond
that (a take first lets go of what lies beyond its own bytes).  So the pool
never holds more than one call's worth of pages that no output uses.  In a
closed loop, where the caller holds the last call's output while it makes
the next call, the mapping reused is that of the output two calls back.
Without the pool that output would have been unmapped just before the next
call mapped and touched as many fresh bytes, so the peak resident set is
the same and only the pages' first touches go.

What stays resident: after the caller drops every output, the pool keeps
up to the bytes of the most recent take's pooled outputs mapped, until the
next take or the process's end.  The next take keeps only what it itself
takes, so a call whose outputs are all under the threshold lets go of them
all."""

from __future__ import annotations

import mmap
import threading
import weakref

import numpy as np

THRESHOLD_BYTES = 32 << 20  # glibc's DEFAULT_MMAP_THRESHOLD_MAX on 64-bit: it recycles nothing this large


class OutputPool:
    """Free mappings for outputs of THRESHOLD_BYTES or more, at most the
    bytes of the most recent take (the module's docstring)."""

    def __init__(self):
        self._free: list[mmap.mmap] = []
        self._free_bytes = 0
        self._cap = 0
        # Reentrant: the cyclic collector may run an output's finalizer inside take.
        self._lock = threading.RLock()

    @property
    def free_bytes(self) -> int:
        return self._free_bytes

    def take(self, lengths) -> tuple[list[np.ndarray], int, int]:
        """(outputs, pooled_bytes, reused_bytes): an int16 array of each
        of `lengths` samples, from np.empty below THRESHOLD_BYTES and from
        the pool at or above it; the pooled outputs' bytes, and the bytes of
        those served from a recycled mapping."""
        outs, pooled, reused, taken = [], 0, 0, 0
        with self._lock:
            for n in lengths:
                nbytes = 2 * n
                if nbytes < THRESHOLD_BYTES:
                    outs.append(np.empty(n, np.int16))
                    continue
                mm = self._pop(nbytes)
                if mm is None:
                    mm = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE)
                else:
                    reused += nbytes
                pooled += nbytes
                taken += len(mm)
                out = np.frombuffer(mm, np.int16, n)
                weakref.finalize(out, self._give_back, mm).atexit = False
                outs.append(out)
            self._cap = taken
            while self._free_bytes > self._cap:  # the largest first
                mm = self._free.pop(max(range(len(self._free)), key=lambda i: len(self._free[i])))
                self._free_bytes -= len(mm)
        return outs, pooled, reused

    def _pop(self, nbytes: int) -> mmap.mmap | None:
        """The smallest free mapping of nbytes to 2 * nbytes, taken out."""
        fits = [i for i, mm in enumerate(self._free) if nbytes <= len(mm) <= 2 * nbytes]
        if not fits:
            return None
        mm = self._free.pop(min(fits, key=lambda i: len(self._free[i])))
        self._free_bytes -= len(mm)
        return mm

    def _give_back(self, mm: mmap.mmap) -> None:
        """An output's finalizer: keep its mapping within the cap, else let go of it."""
        with self._lock:
            if self._free_bytes + len(mm) <= self._cap:
                self._free.append(mm)
                self._free_bytes += len(mm)


POOL = OutputPool()
