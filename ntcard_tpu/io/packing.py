"""Packing sequence records into dense device batches.

Device layout: every record is appended to one virtual base-code stream
with a single N separator between records (an N invalidates exactly the
windows that would span a record boundary, so per-record k-mer semantics are
preserved bit-exactly while lanes stay ~99% occupied). The stream is cut into
fixed-length chunks of ``chunk_len`` bases at stride ``stride = chunk_len -
(kmax-1)``: consecutive chunks overlap by the kmax-1-base *halo*, so every
window of the stream is fully visible to exactly one owning chunk (the
sequence-parallel analog called out in SURVEY.md §5). Chunks are stacked into
``[batch_rows, chunk_len]`` uint8 batches; the final partial batch is padded
with all-N rows (zero contribution).

This replaces the reference's per-read std::string hashing loop
(ntcard.cpp:147-171) and its whole-chromosome single-string FASTA handling
(ntcard.cpp:195-201) with a single uniform layout.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional

import numpy as np

from ntcard_tpu.constants import ASCII_TO_CODE, N


def pack_wire(batch: np.ndarray, wire_fmt, stride: int) -> np.ndarray:
    """Pack a raw [B, L] code batch into the requested H2D wire format
    ("quad2" / "quad" / truthy = nibble / falsy = raw), with the per-batch
    fallback chain the fused native path applies (quad2/quad -> nibble on
    N-count overflow). One place for every python-side wire encode."""
    if wire_fmt == "quad2":
        w = pack_rows_quad2(batch, stride)
        return w if w is not None else pack_rows(batch)
    if wire_fmt == "quad":
        w = pack_rows_quad(batch)
        return w if w is not None else pack_rows(batch)
    return pack_rows(batch) if wire_fmt else batch


def pack_shard_wires(batch: np.ndarray, n_dev: int, wire_fmt, stride: int) -> np.ndarray:
    """Split a raw [B, L] code batch into n_dev equal row blocks and wire-
    pack EACH block (per-shard sidecars), returning a [n_dev, rows, width]
    stack for ShardedCountTableSketch.update_shards. Quad-family delta
    sidecars are global to their wire, so row-sharding a single wire batch
    is impossible — but a row block is itself a valid batch (quad2's
    consecutive-span precondition survives slicing), so packing per shard
    makes every wire format shardable. If any shard's quad pack overflows
    (shapes would diverge), the whole batch falls back to per-shard nibble
    — the stack must be format-homogeneous for one jit signature."""
    B = batch.shape[0]
    if B % n_dev:
        raise ValueError(f"batch rows ({B}) must divide by n_dev ({n_dev})")
    rows = B // n_dev
    blocks = [batch[d * rows : (d + 1) * rows] for d in range(n_dev)]
    if wire_fmt in ("quad", "quad2"):
        packs = [pack_wire(blk, wire_fmt, stride) for blk in blocks]
        if len({p.shape for p in packs}) == 1:
            return np.stack(packs)
    return np.stack([pack_rows(blk) for blk in blocks])


def pack_rows(batch: np.ndarray) -> np.ndarray:
    """Nibble-pack a [B, L] uint8 code batch to [B/2, L]: chunk row b rides
    in the high nibble, row b + B/2 in the low nibble of the same byte.

    Rows are independent chunks (each carries its own halo) and the sketch
    fold commutes, so any row-to-byte pairing is semantics-free. It halves
    the host->device payload; the device inverse is ops.nthash.unpack_rows."""
    B = batch.shape[0]
    if B % 2:
        raise ValueError("batch must have an even number of rows to nibble-pack")
    return (batch[: B // 2] << 4) | batch[B // 2 :]


def unpack_rows_np(packed: np.ndarray) -> np.ndarray:
    """Host-side inverse of pack_rows (test/debug use)."""
    return np.concatenate([packed >> 4, packed & 0x0F], axis=0)


# --- quad wire: 2 bits/base + delta-coded N positions -----------------------
#
# Fewer wire bytes mean less host->device transfer per base. 2 bits/base is
# the information floor for ACGT; N positions (record separators, real Ns, pad)
# travel as a uint16 delta stream appended to the same array (one transfer).
# The device rebuilds the exact nibble-path code stream: 2-bit unpack + one
# scatter-set of N_CODE at the decoded positions (ops/nthash.unpack_quad),
# so every downstream bit is unchanged.
#
# Delta stream spec (entries little-endian uint16, column-major over the
# device's [nslots/128, 128] view so position decode is a cheap per-column
# cumsum + tiny lane prefix):
#   0..65533  advance by v from the previous N position (first entry is the
#             absolute flat position in [B, L] row-major space) and mark
#   0xFFFF    advance by 65533, no mark (gap chaining)
#   0xFFFE    pad: no advance, no mark
_QUAD_MAX_DELTA = 65533
QUAD_PAD = 0xFFFE
QUAD_SKIP = 0xFFFF


def quad_delta_rows(batch_rows: int) -> int:
    """uint8 rows appended for the delta stream: slots = B*L/128 (one slot
    per 128 bases covers >=130bp-read workloads; denser N/record content
    overflows and falls back to the nibble wire per batch)."""
    return batch_rows // 64


def quad_wire_rows(batch_rows: int) -> int:
    return batch_rows // 4 + quad_delta_rows(batch_rows)


def quad_ok(batch_rows: int, chunk_len: int) -> bool:
    """Geometry admissibility of the quad wire (see pack_rows_quad)."""
    if batch_rows % 64 or chunk_len % 2:
        return False
    return (quad_delta_rows(batch_rows) * chunk_len // 2) % 128 == 0


def wire_mode_of(wire: np.ndarray, batch_rows: int, halo: int | None = None) -> str:
    """Which wire format a packed batch is in, by row count. For quad2 the
    caller must supply the halo width (it is not recoverable from the wire)
    and receives the jit-static ``"quad2:<halo>"`` mode string."""
    r = wire.shape[0]
    if r == batch_rows // 2:
        return "nibble"
    if r == quad_wire_rows(batch_rows):
        return "quad"
    if r == quad2_wire_rows(batch_rows):
        if halo is None:
            raise ValueError("quad2 wire needs the halo width (chunk_len - stride)")
        return f"quad2:{halo}"
    raise ValueError(f"not a wire batch for batch_rows={batch_rows}: rows={r}")


def pack_rows_quad(batch: np.ndarray) -> Optional[np.ndarray]:
    """Quad-pack a [B, L] uint8 code batch to [B/4 + B/64, L], or None when
    the geometry is inadmissible or the N count overflows the delta slots
    (callers then use pack_rows). Byte layout: rows [0, B/4) carry rows
    b, b+B/4, b+2B/4, b+3B/4 at 2 bits each (N sent as 0 and restored from
    the delta stream); the tail rows carry the delta stream."""
    B, L = batch.shape
    if not quad_ok(B, L):
        return None
    g = B // 4
    drows = quad_delta_rows(B)
    nslots = drows * L // 2
    pos = np.flatnonzero(batch == N)
    if len(pos) > nslots:
        return None
    d = np.diff(pos, prepend=0)
    skips = np.maximum(0, (d - 1) // _QUAD_MAX_DELTA)
    total = len(pos) + int(skips.sum())
    if total > nslots:
        return None
    stream = np.full(nslots, QUAD_PAD, np.uint16)
    stream[:total] = QUAD_SKIP
    if len(pos):
        stream[np.cumsum(skips + 1) - 1] = (d - skips * _QUAD_MAX_DELTA).astype(np.uint16)
    q = np.where(batch == N, 0, batch).astype(np.uint8)
    w = q[:g] | (q[g : 2 * g] << 2) | (q[2 * g : 3 * g] << 4) | (q[3 * g :] << 6)
    # column-major over the device's [nslots/128, 128] view
    cm = np.ascontiguousarray(stream.reshape(128, nslots // 128).T)
    tail = cm.reshape(-1).view(np.uint8).reshape(drows, L)
    return np.concatenate([w, tail], axis=0)


# --- quad2 wire: owned-span 2-bit payload + uint8 sidecar + borrowed halo --
#
# The quad wire still ships every chunk's (kmax-1)-base halo (~6.7% of bytes
# at L=1024) and a uint16 N sidecar (~5.9%). quad2 removes both: rows carry
# ONLY their owned stride-span at 2 bits/base, and the halo is rebuilt on
# device from the NEXT stream chunk — which is simply the next lane of the
# same batch (chunks are consecutive stream spans). Only the last lane's
# halo must travel: one raw-code tail row. The N sidecar entries become
# plain stream offsets (owned spans tile the stream exactly, no halo
# duplicates) delta-coded in uint8:
#   0..239   advance by v from the previous N position and mark
#   240..253 advance by (v-239)*240, no mark (gap chaining, <=3360/entry;
#            the remainder after skips always lands back in [0, 239])
#   254      fill: every stream position after the current one is N (the
#            all-N pad tail of a flush batch — without this the pad Ns
#            overflow the sidecar and the whole batch falls back to the
#            2x-bigger nibble wire)
#   255      pad: no advance, no mark
# Wire: [B/4 + B/128 + 1, stride] uint8 = ~2.06 bits per owned base (vs
# quad's ~2.27): payload rows, sidecar rows (1 slot per 128 owned bases,
# same >=129bp-record coverage as quad), then the tail row (halo raw codes,
# N-padded). Device inverse: ops/nthash.unpack_quad2.
_QUAD2_MAX_DELTA = 239
_QUAD2_SKIP_UNIT = 240
QUAD2_FILL = 254
QUAD2_PAD = 255


def quad2_delta_rows(batch_rows: int) -> int:
    return batch_rows // 128


def quad2_wire_rows(batch_rows: int) -> int:
    return batch_rows // 4 + quad2_delta_rows(batch_rows) + 1


def quad2_ok(batch_rows: int, stride: int) -> bool:
    if batch_rows % 128 or batch_rows < 256:
        return False
    return (quad2_delta_rows(batch_rows) * stride) % 128 == 0


def pack_rows_quad2(batch: np.ndarray, stride: int) -> Optional[np.ndarray]:
    """quad2-pack a [B, L] uint8 code batch (L = stride + halo) to
    [B/4 + B/128 + 1, stride], or None when the geometry is inadmissible or
    the N count overflows the sidecar slots (callers then fall back).

    PRECONDITION: rows must be consecutive spans of one code stream —
    batch[b, S:] == batch[b+1, :halo] for every b (the device rebuilds each
    row's halo from the *next row's owned span*, so only the owned [:, :S]
    spans are encoded). StreamPacker/NativePacker batches satisfy this by
    construction; an arbitrary [B, L] batch violating it decodes to
    different codes with no error — validated here (cheap row-shift
    compare) with a None return so such callers fall back to nibble."""
    B, L = batch.shape
    S = stride
    halo = L - S
    if halo < 1 or halo > S or not quad2_ok(B, S):
        return None
    if not np.array_equal(batch[:-1, S:], batch[1:, :halo]):
        return None  # not consecutive stream spans: quad2 cannot encode it
    g = B // 4
    drows = quad2_delta_rows(B)
    nslots = drows * S
    own = batch[:, :S]
    pos = np.flatnonzero(own == N)
    fill = False
    if len(pos) and pos[-1] == B * S - 1:
        # all-N suffix (flush-batch padding): mark its first N normally,
        # then one fill entry covers the rest
        nz = np.flatnonzero(own != N)
        q = int(nz[-1]) if len(nz) else -1
        pos = np.concatenate([pos[pos <= q], [q + 1]])
        fill = True
    stream_entries = []
    prev = 0
    for p in pos:
        dd = int(p) - prev
        while dd > _QUAD2_MAX_DELTA:
            u = min(14, dd // _QUAD2_SKIP_UNIT)  # dd >= 240 => u >= 1; 253 max code
            stream_entries.append(_QUAD2_MAX_DELTA + u)
            dd -= u * _QUAD2_SKIP_UNIT
        stream_entries.append(dd)
        prev = int(p)
    if fill:
        stream_entries.append(QUAD2_FILL)
    if len(stream_entries) > nslots:
        return None
    stream = np.full(nslots, QUAD2_PAD, np.uint8)
    stream[: len(stream_entries)] = np.asarray(stream_entries, np.uint8)
    q = np.where(own == N, 0, own).astype(np.uint8)
    w = q[:g] | (q[g : 2 * g] << 2) | (q[2 * g : 3 * g] << 4) | (q[3 * g :] << 6)
    # column-major over the device's [nslots/128, 128] view
    cm = np.ascontiguousarray(stream.reshape(128, nslots // 128).T)
    tail_rows = cm.reshape(drows, S)
    halo_row = np.full((1, S), N, np.uint8)
    halo_row[0, :halo] = batch[B - 1, S:]
    return np.concatenate([w, tail_rows, halo_row], axis=0)


def aligned_stride(chunk_len: int, kmax: int) -> int:
    """Owned window starts per chunk: at most chunk_len - (kmax-1) so every
    window is fully in-chunk, rounded DOWN to a multiple of 8, so the
    kernel's [stride, B] shapes and the quad2 wire's row groups stay
    8-aligned; the extra overlap (< 8 bases) is just a slightly larger
    halo."""
    s = ((chunk_len - kmax + 1) // 8) * 8
    if s < 8:
        raise ValueError(f"chunk_len ({chunk_len}) too small for kmax ({kmax})")
    return s


class StreamPacker:
    """Incremental packer: feed records, collect ``[B, L]`` uint8 batches."""

    def __init__(self, chunk_len: int = 1024, batch_rows: int = 1024, kmax: int = 64):
        if kmax < 1:
            raise ValueError("kmax must be >= 1")
        if chunk_len <= kmax:
            raise ValueError(f"chunk_len ({chunk_len}) must exceed kmax ({kmax})")
        if batch_rows % 128:
            raise ValueError("batch_rows must be a multiple of 128")
        self.chunk_len = chunk_len
        self.batch_rows = batch_rows
        self.stride = aligned_stride(chunk_len, kmax)
        # bases covered by one batch's owned starts:
        self._batch_span = self.batch_rows * self.stride
        # bases that must be buffered before a batch can be emitted:
        self._need = (self.batch_rows - 1) * self.stride + self.chunk_len
        self._buf = np.empty(self._need + (self.chunk_len * 2), dtype=np.uint8)
        self._n = 0  # filled bases in _buf
        self._real = 0  # real (non-pad) bases currently in _buf
        self.total_bases = 0  # stream statistics (bases incl. separators)
        self.total_records = 0

    def _grow(self, extra: int):
        need = self._n + extra
        if need > self._buf.size:
            newbuf = np.empty(max(need, self._buf.size * 2), dtype=np.uint8)
            newbuf[: self._n] = self._buf[: self._n]
            self._buf = newbuf

    def feed(self, seq: bytes) -> Iterator[np.ndarray]:
        """Append one record (+ separator); yield any completed batches."""
        self.total_records += 1
        m = len(seq)
        self._grow(m + 1)
        if m:
            codes = ASCII_TO_CODE[np.frombuffer(seq, dtype=np.uint8)]
            self._buf[self._n : self._n + m] = codes
        self._buf[self._n + m] = N  # record separator
        self._n += m + 1
        self._real = self._n
        self.total_bases += m + 1
        while self._n >= self._need:
            yield self._emit()

    def _emit(self) -> np.ndarray:
        B, L, S = self.batch_rows, self.chunk_len, self.stride
        view = np.lib.stride_tricks.as_strided(
            self._buf, shape=(B, L), strides=(S * self._buf.strides[0], self._buf.strides[0])
        )
        batch = np.ascontiguousarray(view)
        # drop the consumed owned spans; keep the tail (incl. halo) for next batch
        rest = self._n - self._batch_span
        self._buf[:rest] = self._buf[self._batch_span : self._n]
        self._n = rest
        self._real = max(0, self._real - self._batch_span)
        return batch

    def finish(self) -> Iterator[np.ndarray]:
        """Flush: emit padded batches until every real base's windows have an
        owning chunk, then reset."""
        while self._real > 0:
            self._grow(self._need - self._n)
            self._buf[self._n : self._need] = N
            self._n = self._need
            yield self._emit()
        self._n = 0
        self._real = 0


def pack_records(
    records: Iterable[bytes],
    chunk_len: int = 1024,
    batch_rows: int = 1024,
    kmax: int = 64,
    packer: Optional[StreamPacker] = None,
) -> Iterator[np.ndarray]:
    """Pack an iterable of records into a stream of [B, L] uint8 batches."""
    p = packer or StreamPacker(chunk_len, batch_rows, kmax)
    for seq in records:
        yield from p.feed(seq)
    yield from p.finish()
