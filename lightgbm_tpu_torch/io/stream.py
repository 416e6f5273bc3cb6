"""Out-of-core streaming: the binned rows stay on the host, chunks go up.

Port of lightgbm_tpu/io/stream.py. The binned matrix stays in host memory
in the bit-packed wire format the compact and chunk cores use on the
device (``DeviceTreeLearner.pack_codes``: 4-bit codes when every declared
column fits a nibble, else 8 or 16 bits, packed into 32-bit words), so a
chunk transfer is a copy of packed words and nothing is re-encoded.

On the card the wire store is a pinned host tensor. ``iter_chunks``
copies each chunk on a side CUDA stream (``copy_(non_blocking=True)``, a
cudaMemcpyAsync) into one of two device chunk buffers, and issues the copy
of chunk i + 1 before the caller gets chunk i, so the next transfer
overlaps what the caller does with the current chunk. The copy stream
waits on an event for the compute stream to finish with a buffer before it
overwrites it; the compute stream waits on the copy's event before the
caller's work, and each buffer is ``record_stream``-ed on the compute
stream so the caching allocator does not hand it out early. On the CPU the
same chunks move as plain copies, without pinning or a side stream.

The shard keeps its transfer counters as plain numbers: ``h2d_bytes``,
the host's blocking ``wait_seconds`` (the wait for each chunk's copy) and
``stream_seconds`` (the wall of the streaming passes), from which
``overlap_fraction`` = 1 - wait / span. It also holds the GOSS working
set (top-gradient rows pinned on the device across iterations,
``stream_mode=goss``), the device-byte accounting that
``DeviceTreeLearner.device_data_bytes`` reports, and the stream cursor
and working-set ids that ``stream_state`` / ``load_stream_state`` carry.

Chunking is pure data movement: the trained model is the same for any
chunk size.
"""
from __future__ import annotations

import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

__all__ = ["DeviceDataShard", "derive_stream_chunk_rows"]


def derive_stream_chunk_rows(requested: int, core_chunk_rows: int) -> int:
    """The rows per transfer: an explicit ``stream_chunk_rows`` wins; 0
    takes the growth core's chunk size (one stream chunk per core chunk).
    Floored at 1,024 rows, below which the per-transfer latency cannot be
    hidden."""
    rows = int(requested) if int(requested) > 0 else int(core_chunk_rows)
    return max(1024, rows)


class DeviceDataShard:
    """Host wire store and the double-buffered chunk pipeline to `device`.

    `packed_codes` is the (N, CW) uint32 array of bit-packed row codes
    (`item_bits` codes of `c_cols` columns per row), the same bytes as the
    resident ``codes_pack``. Callers register the device buffers they hold
    with ``track_buffer`` / ``release_buffer``; the shard adds its own
    chunk buffers and working set, and ``peak_bytes`` is the high-water
    mark of the sum."""

    def __init__(self, packed_codes: np.ndarray, *, item_bits: int,
                 c_cols: int, chunk_rows: int = 0,
                 core_chunk_rows: int = 65536, device="cpu"):
        wire = np.ascontiguousarray(np.asarray(packed_codes))
        if wire.dtype != np.uint32 or wire.ndim != 2:
            raise ValueError("DeviceDataShard wants (N, CW) u32 packed "
                             f"codes, got {wire.dtype} {wire.shape}")
        self.device = torch.device(device)
        self.item_bits = int(item_bits)
        self.c_cols = int(c_cols)
        self.chunk_rows = derive_stream_chunk_rows(chunk_rows,
                                                   core_chunk_rows)
        self._set_wire(wire)
        # the stream cursor: chunks transferred so far (bookkeeping that a
        # resumed run carries; assembly does not depend on it)
        self.cursor = 0
        self.ws_ids = np.zeros(0, np.int32)
        self._ws_rows: Optional[torch.Tensor] = None
        self._live: Dict[str, int] = {}
        self.peak_bytes = 0
        self.h2d_bytes = 0
        self.stream_seconds = 0.0
        self.wait_seconds = 0.0
        self._side: Optional["torch.cuda.Stream"] = None

    def _set_wire(self, wire: np.ndarray) -> None:
        t = torch.from_numpy(wire.view(np.int32))
        if self.device.type == "cuda":
            t = t.pin_memory()
        self.wire = t
        self.num_rows, self.code_words = wire.shape

    # -- device-byte accounting ----------------------------------------
    def track_buffer(self, name: str, nbytes: int) -> None:
        self._live[name] = int(nbytes)
        total = sum(self._live.values())
        if total > self.peak_bytes:
            self.peak_bytes = total

    def release_buffer(self, name: str) -> None:
        self._live.pop(name, None)

    def live_bytes(self) -> int:
        return sum(self._live.values())

    @property
    def host_bytes(self) -> int:
        return int(self.wire.numel() * 4)

    def overlap_fraction(self) -> Optional[float]:
        """1 - (blocking wait / streaming-pass wall): ~1 when every
        transfer hid behind the caller's work, ~0 when the passes waited
        on transfers; None before the first pass."""
        if self.stream_seconds <= 0.0:
            return None
        return max(0.0, 1.0 - self.wait_seconds / self.stream_seconds)

    # -- the double-buffered pipeline ----------------------------------
    def _host_rows(self, s: int, e: int, row_ids, staging):
        """Wire rows [s, e) (of `row_ids` when given) as a host tensor: a
        slice of the wire, or the rows gathered into `staging`."""
        if row_ids is None:
            return self.wire[s:e]
        ids = torch.from_numpy(row_ids[s:e])
        if staging is None:
            return self.wire.index_select(0, ids)
        out = staging[:e - s]
        torch.index_select(self.wire, 0, ids, out=out)
        return out

    def iter_chunks(self, row_ids: Optional[np.ndarray] = None
                    ) -> Iterator[Tuple[int, int, torch.Tensor]]:
        """Yield (start, count, device chunk (count, CW) int32) over the
        wire rows, or over the rows `row_ids` in their order, the copy of
        chunk i + 1 issued before chunk i is yielded. Every chunk but the
        last has exactly ``chunk_rows`` rows. A chunk is valid until the
        next one is asked for (its buffer is then refilled)."""
        if row_ids is not None:
            row_ids = np.ascontiguousarray(row_ids, dtype=np.int64)
        n = self.num_rows if row_ids is None else int(row_ids.size)
        if n == 0:
            return
        sc = self.chunk_rows
        nch = -(-n // sc)
        cuda = self.device.type == "cuda"
        self.track_buffer("stream_inflight",
                          2 * min(sc, n) * self.code_words * 4)
        t_pass = time.perf_counter()
        if not cuda:
            try:
                for i in range(nch):
                    s, e = i * sc, min(n, (i + 1) * sc)
                    chunk = self._host_rows(s, e, row_ids, None).clone()
                    self.h2d_bytes += int(chunk.numel() * 4)
                    yield s, e - s, chunk
                self.cursor += nch
            finally:
                self.release_buffer("stream_inflight")
                self.stream_seconds += time.perf_counter() - t_pass
            return

        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        side = self._side
        compute = torch.cuda.current_stream(self.device)
        rows = min(sc, n)
        with torch.cuda.stream(side):
            bufs = [torch.empty((rows, self.code_words), dtype=torch.int32,
                                device=self.device) for _ in range(2)]
        staging = None if row_ids is None else [
            torch.empty((rows, self.code_words),
                        dtype=torch.int32).pin_memory() for _ in range(2)]
        copied = [torch.cuda.Event() for _ in range(2)]
        free = [torch.cuda.Event() for _ in range(2)]
        used = [False, False]

        def dispatch(i: int):
            slot = i % 2
            s, e = i * sc, min(n, (i + 1) * sc)
            if staging is not None and used[slot]:
                # the slot's earlier copy must have read its staging
                copied[slot].synchronize()
            src = self._host_rows(s, e, row_ids,
                                  None if staging is None else staging[slot])
            dst = bufs[slot][:e - s]
            if used[slot]:
                # the compute stream is done with this buffer's last chunk
                side.wait_event(free[slot])
            with torch.cuda.stream(side):
                dst.copy_(src, non_blocking=True)
                copied[slot].record(side)
            used[slot] = True
            return s, e - s, slot, dst

        try:
            pend = dispatch(0)
            for i in range(nch):
                nxt = dispatch(i + 1) if i + 1 < nch else None
                s, cnt, slot, dev = pend
                t0 = time.perf_counter()
                copied[slot].synchronize()
                self.wait_seconds += time.perf_counter() - t0
                compute.wait_event(copied[slot])
                dev.record_stream(compute)
                self.h2d_bytes += cnt * self.code_words * 4
                yield s, cnt, dev
                free[slot].record(compute)
                pend = nxt
            self.cursor += nch
        finally:
            self.release_buffer("stream_inflight")
            self.stream_seconds += time.perf_counter() - t_pass

    # -- GOSS working set ----------------------------------------------
    def pin_working_set(self, ids: np.ndarray,
                        rows: Optional[torch.Tensor] = None) -> None:
        """Keep the rows `ids` (sorted row ids) on the device. `rows`:
        their (len(ids), CW) int32 codes when the caller already holds
        them there (no transfer); None uploads them from the wire store
        (a resumed run). Codes never change, so both hold the same
        words."""
        ids = np.asarray(ids, dtype=np.int32)
        if rows is None and ids.size:
            host = self.wire.index_select(
                0, torch.from_numpy(ids.astype(np.int64)))
            rows = host.to(self.device)
            self.h2d_bytes += int(host.numel() * 4)
        self.ws_ids = ids
        self._ws_rows = rows if ids.size else None
        if ids.size:
            self.track_buffer("working_set",
                              int(ids.size) * self.code_words * 4)
        else:
            self.release_buffer("working_set")

    def working_set(self) -> Tuple[np.ndarray, Optional[torch.Tensor]]:
        return self.ws_ids, self._ws_rows

    # -- appended rows ---------------------------------------------------
    def append_rows(self, packed_rows: np.ndarray) -> int:
        """Append rows packed in the shard's layout (same item_bits and
        c_cols) to the wire store; returns the new row count. Row ids,
        the cursor, the working set and the accounting keep their
        meaning."""
        block = np.ascontiguousarray(np.asarray(packed_rows))
        if block.dtype != np.uint32 or block.ndim != 2 \
                or block.shape[1] != self.code_words:
            raise ValueError(
                f"append_rows wants (M, {self.code_words}) u32 packed "
                f"codes, got {block.dtype} {block.shape}")
        wire = self.wire.numpy().view(np.uint32)
        self._set_wire(np.concatenate([wire, block], axis=0))
        return self.num_rows

    # -- checkpoint round trip -------------------------------------------
    def stream_state(self) -> Dict[str, object]:
        return {"cursor": int(self.cursor),
                "ws_ids": np.asarray(self.ws_ids, dtype=np.int32)}

    def load_stream_state(self, st: Dict[str, object]) -> None:
        self.cursor = int(st.get("cursor", 0))
        ws = np.asarray(st.get("ws_ids", np.zeros(0, np.int32)),
                        dtype=np.int32)
        self.pin_working_set(ws)
