"""File-id sequencers (reference weed/sequence: memory_sequencer.go,
snowflake_sequencer.go).

The port's copy of seaweedfs_tpu/cluster/sequence.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import threading
import time


class MemorySequencer:
    def __init__(self, start: int = 1):
        self._counter = start
        self._lock = threading.Lock()

    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            start = self._counter
            self._counter += count
            return start

    def set_max(self, seen: int) -> None:
        with self._lock:
            if seen > self._counter:
                self._counter = seen + 1

    def peek(self) -> int:
        return self._counter


class SnowflakeSequencer:
    """41-bit ms timestamp | 10-bit node | 12-bit sequence."""

    EPOCH_MS = 1577836800000  # 2020-01-01

    def __init__(self, node_id: int = 1):
        assert 0 <= node_id < 1024
        self.node_id = node_id
        self._lock = threading.Lock()
        self._last_ms = 0
        self._seq = 0

    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            now = int(time.time() * 1000) - self.EPOCH_MS  # IDs embed the absolute epoch
            if now == self._last_ms:
                self._seq += count
                if self._seq >= 4096:
                    while now <= self._last_ms:
                        now = int(time.time() * 1000) - self.EPOCH_MS  # IDs embed the absolute epoch
                    self._seq = 0
            else:
                self._seq = 0
            self._last_ms = now
            return (now << 22) | (self.node_id << 12) | self._seq

    def set_max(self, seen: int) -> None:
        pass
