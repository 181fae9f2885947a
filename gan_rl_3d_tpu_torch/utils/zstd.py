"""Zstandard frame decoder (RFC 8878) in Python and numpy.

The port reads the JAX package's orbax checkpoints, whose arrays and
OCDBT nodes are zstd frames, on machines that have no zstd binding; this
module is that decoder. It covers raw, RLE and compressed blocks; raw,
RLE, Huffman and treeless literals in one or four streams, with direct or
FSE-coded Huffman weights; predefined, RLE, FSE and repeat sequence
tables; repeat offsets; frames with or without a content size; and
several frames back to back. A frame's content checksum
(XXH64, low 32 bits) is verified. A frame that names a dictionary is
refused.

Decoding runs in three passes over every frame of a call:

1. The frames' headers, literal headers, Huffman tables and sequences are
   parsed in Python. A sequence needs the literals' lengths only, never
   their bytes, so every Huffman-coded literal stream becomes a job: its
   bytes, its table and its symbol count.
2. All jobs of the call decode together (``_decode_huffman``): one lane a
   stream, one numpy step a symbol index over every lane. A step looks up
   an 11-bit window at each lane's bit position in the lane's table,
   which gives the symbol and how far the position moves. The steps are
   the longest stream's symbols (at most 32,768), however many streams
   there are, so ``decompress_many`` over all chunks of a checkpoint
   costs about what one large chunk costs.
3. Each block's sequences copy literals and matches into the frame's
   output.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

FRAME_MAGIC = 0xFD2FB528
HUF_BITS = 11  # zstd's largest Huffman code; every table is widened to it

# literal and match length codes: (baseline, extra bits), RFC 8878 3.1.1.3.2.1.1
_LL = ([(i, 0) for i in range(16)]
       + [(16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3),
          (40, 3), (48, 4), (64, 6), (128, 7), (256, 8), (512, 9),
          (1024, 10), (2048, 11), (4096, 12), (8192, 13), (16384, 14),
          (32768, 15), (65536, 16)])
_ML = ([(i + 3, 0) for i in range(32)]
       + [(35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3),
          (59, 3), (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9),
          (1027, 10), (2051, 11), (4099, 12), (8195, 13), (16387, 14),
          (32771, 15), (65539, 16)])
# predefined distributions (RFC 8878 3.1.1.3.2.2)
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
                2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
_MAX_LOG = {"ll": 9, "of": 8, "ml": 9}


def _corrupt(what: str) -> ValueError:
    return ValueError(f"zstd: corrupt input ({what})")


# ---------------------------------------------------------------------------
# bit readers
# ---------------------------------------------------------------------------


class _Forward:
    """Little-endian forward bits (FSE table descriptions)."""

    def __init__(self, data: bytes):
        self.x = int.from_bytes(data, "little")
        self.n = len(data) * 8
        self.pos = 0

    def read(self, n: int) -> int:
        if self.pos + n > self.n:
            raise _corrupt("table description overruns its block")
        v = (self.x >> self.pos) & ((1 << n) - 1)
        self.pos += n
        return v


class _Backward:
    """A zstd backward bitstream: read from the end, after the highest set
    bit of the last byte. Reads below the start give zero bits, as the
    format allows for the last state updates."""

    _PAD = 8

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise _corrupt("bitstream without its end mark")
        self.buf = bytes(self._PAD) + bytes(data)
        self.pos = self._PAD * 8 + (len(data) - 1) * 8 + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        p = self.pos
        if p < 0:
            raise _corrupt("bitstream overread")
        v = int.from_bytes(self.buf[p >> 3:(p + n + 7 >> 3)], "little")
        return (v >> (p & 7)) & ((1 << n) - 1)

    def overread(self) -> bool:
        return self.pos < self._PAD * 8

    def exhausted(self) -> bool:
        return self.pos == self._PAD * 8


# ---------------------------------------------------------------------------
# FSE
# ---------------------------------------------------------------------------


class _Fse:
    """An FSE decoding table: per state its symbol, the bits to read and
    the base of the next state."""

    def __init__(self, symbol: List[int], nbits: List[int], base: List[int],
                 log: int):
        self.symbol, self.nbits, self.base, self.log = symbol, nbits, base, log

    @classmethod
    def from_counts(cls, counts: Sequence[int], log: int) -> "_Fse":
        size = 1 << log
        symbol = [0] * size
        high = size
        nxt = [0] * len(counts)
        for s, c in enumerate(counts):
            if c == -1:
                high -= 1
                symbol[high] = s
                nxt[s] = 1
        step = (size >> 1) + (size >> 3) + 3
        mask, pos = size - 1, 0
        for s, c in enumerate(counts):
            if c <= 0:
                continue
            nxt[s] = c
            for _ in range(c):
                symbol[pos] = s
                pos = (pos + step) & mask
                while pos >= high:
                    pos = (pos + step) & mask
        if pos != 0:
            raise _corrupt("FSE distribution does not fill its table")
        nbits, base = [0] * size, [0] * size
        for i in range(size):
            s = symbol[i]
            d = nxt[s]
            nxt[s] += 1
            nbits[i] = log - (d.bit_length() - 1)
            base[i] = (d << nbits[i]) - size
        return cls(symbol, nbits, base, log)

    @classmethod
    def rle(cls, sym: int) -> "_Fse":
        return cls([sym], [0], [0], 0)


def _read_fse_description(data: bytes, max_log: int):
    """(counts, accuracy log, bytes used) of an FSE table description
    (RFC 8878 4.1.1)."""
    bits = _Forward(data)
    log = bits.read(4) + 5
    if log > max_log:
        raise _corrupt(f"FSE accuracy log {log} above {max_log}")
    remaining = 1 << log
    counts: List[int] = []
    while remaining > 0:
        if len(counts) > 255:
            raise _corrupt("FSE description has too many symbols")
        nb = (remaining + 1).bit_length()
        val = bits.read(nb)
        lower = (1 << (nb - 1)) - 1
        threshold = (1 << nb) - 1 - (remaining + 1)
        if (val & lower) < threshold:
            bits.pos -= 1
            val &= lower
        elif val > lower:
            val -= threshold
        count = val - 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        if count == 0:
            while True:
                rep = bits.read(2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
    if remaining != 0:
        raise _corrupt("FSE distribution overfills its table")
    return counts, log, (bits.pos + 7) >> 3


# ---------------------------------------------------------------------------
# Huffman
# ---------------------------------------------------------------------------


def _huffman_weights(data: bytes, pos: int):
    """The explicit weights of a Huffman tree description and its end."""
    header = data[pos]
    pos += 1
    if header >= 128:
        n = header - 127
        raw = data[pos:pos + (n + 1) // 2]
        if len(raw) < (n + 1) // 2:
            raise _corrupt("Huffman weights overrun the literals")
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return weights[:n], pos + (n + 1) // 2
    section = data[pos:pos + header]
    if len(section) < header or header == 0:
        raise _corrupt("Huffman weights overrun the literals")
    counts, log, used = _read_fse_description(section, 6)
    table = _Fse.from_counts(counts, log)
    bits = _Backward(section[used:])
    # two interleaved states take turns; when an update reads past the
    # stream's start, the other state's symbol is the last weight
    states = [bits.read(log), bits.read(log)]
    weights, turn = [], 0
    while len(weights) <= 255:
        s = states[turn]
        weights.append(table.symbol[s])
        states[turn] = table.base[s] + bits.read(table.nbits[s])
        turn ^= 1
        if bits.overread():
            weights.append(table.symbol[states[turn]])
            break
    if len(weights) > 255:
        raise _corrupt("too many Huffman weights")
    return weights, pos + header


def _huffman_table(weights: List[int]) -> np.ndarray:
    """The decoding table of a Huffman tree, widened to HUF_BITS: entry w
    (the next HUF_BITS bits) holds symbol | code length << 8."""
    if any(w > HUF_BITS for w in weights):
        raise _corrupt("Huffman weight above 11")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise _corrupt("empty Huffman tree")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if max_bits > HUF_BITS or rest & (rest - 1):
        raise _corrupt("Huffman weights do not sum to a power of 2")
    weights = list(weights) + [rest.bit_length()]
    table = np.empty(1 << max_bits, np.int64)
    pos = 0
    for w in range(1, max_bits + 1):
        for sym, ws in enumerate(weights):
            if ws == w:
                n = 1 << (w - 1)
                table[pos:pos + n] = sym | (max_bits + 1 - w) << 8
                pos += n
    return np.repeat(table, 1 << (HUF_BITS - max_bits))


def _decode_huffman(jobs) -> List[bytes]:
    """Every Huffman literal stream of a call at once. ``jobs`` holds
    (stream bytes, table, symbols): lane j reads stream j backwards, from
    after its end mark; each step gathers the 11-bit window at every live
    lane's position, looks it up in the lane's table, writes the symbol
    and advances by the code length. A lane must end exactly on its
    stream's first bit."""
    if not jobs:
        return []
    order = sorted(range(len(jobs)), key=lambda j: -jobs[j][2])
    tables, table_ids = [], {}
    parts, starts, ends, tbase, counts = [], [], [], [], []
    offset = 0
    for j in order:
        stream, table, count = jobs[j]
        if not stream or stream[-1] == 0:
            raise _corrupt("Huffman stream without its end mark")
        if id(table) not in table_ids:
            table_ids[id(table)] = len(tables)
            tables.append(table)
        rev = bytes(stream[::-1])
        parts += [rev, bytes(3)]
        # the first byte read is the last one: skip its zeros and end mark
        starts.append(offset * 8 + 9 - stream[-1].bit_length())
        ends.append((offset + len(rev)) * 8)
        tbase.append(table_ids[id(table)] << HUF_BITS)
        counts.append(count)
        offset += len(rev) + 3
    buf = np.frombuffer(b"".join(parts) + bytes(3), np.uint8).astype(np.int64)
    windows = (buf[:-2] << 16) | (buf[1:-1] << 8) | buf[2:]
    lut = np.concatenate(tables)
    pos = np.array(starts, np.int64)
    tbase_a = np.array(tbase, np.int64)
    counts_a = np.array(counts, np.int64)
    out_start = np.concatenate([[0], np.cumsum(counts_a)[:-1]]).astype(np.int64)
    out = np.empty(int(counts_a.sum()), np.uint8)
    # lanes still live at each step: the counts are sorted descending
    live_until = np.searchsorted(-counts_a, -np.arange(counts[0]), "left")
    mask = (1 << HUF_BITS) - 1
    shift0 = 24 - HUF_BITS
    for s in range(counts[0]):
        k = live_until[s]
        p = pos[:k]
        e = lut[tbase_a[:k] + ((windows[p >> 3] >> (shift0 - (p & 7))) & mask)]
        out[out_start[:k] + s] = e
        p += e >> 8
    if not np.array_equal(pos, np.array(ends, np.int64)):
        raise _corrupt("Huffman stream does not end on its first bit")
    result: List[bytes] = [b""] * len(jobs)
    for lane, j in enumerate(order):
        a = int(out_start[lane])
        result[j] = out[a:a + counts[lane]].tobytes()
    return result


# ---------------------------------------------------------------------------
# XXH64 (content checksums)
# ---------------------------------------------------------------------------

_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def _merge(acc: int, v: int) -> int:
    return ((acc ^ _round(0, v)) * _P1 + _P4) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    n = len(data)
    i = 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
             (seed - _P1) & _M64]
        lanes = np.frombuffer(data[:n - n % 32], "<u8").reshape(-1, 4).tolist()
        for row in lanes:
            v = [_round(a, b) for a, b in zip(v, row)]
        i = n - n % 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M64
        for a in v:
            h = _merge(h, a)
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h = (_rotl(h ^ _round(0, int.from_bytes(data[i:i + 8], "little")),
                   27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(data[i:i + 4], "little") * _P1 & _M64),
                   23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h = (_rotl(h ^ (data[i] * _P5 & _M64), 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


class _Frame:
    """One frame's plan: its blocks as ("bytes", data) or ("seq",
    literals, sequences), where literals is bytes or a list of Huffman job
    indices and sequences holds (literal length, match length, offset)."""

    def __init__(self):
        self.blocks: list = []
        self.content_size = None
        self.checksum = None
        self.huffman = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.rep = [1, 4, 8]


def _parse_literals(data: bytes, p: int, frame: _Frame, jobs: list):
    b0 = data[p]
    kind, size_format = b0 & 3, (b0 >> 2) & 3
    if kind < 2:
        if size_format in (0, 2):
            regen, p = b0 >> 3, p + 1
        elif size_format == 1:
            regen, p = (b0 >> 4) + (data[p + 1] << 4), p + 2
        else:
            regen = (b0 >> 4) + (data[p + 1] << 4) + (data[p + 2] << 12)
            p += 3
        if kind == 0:
            lits = data[p:p + regen]
            if len(lits) != regen:
                raise _corrupt("raw literals overrun the block")
            return lits, p + regen
        return bytes(data[p:p + 1]) * regen, p + 1
    nhead = (3, 3, 4, 5)[size_format]
    v = int.from_bytes(data[p:p + nhead], "little")
    field = (10, 10, 14, 18)[size_format]
    regen = (v >> 4) & ((1 << field) - 1)
    size = (v >> (4 + field)) & ((1 << field) - 1)
    p += nhead
    section = data[p:p + size]
    if len(section) != size:
        raise _corrupt("compressed literals overrun the block")
    q = 0
    if kind == 2:
        weights, q = _huffman_weights(section, 0)
        frame.huffman = _huffman_table(weights)
    elif frame.huffman is None:
        raise _corrupt("treeless literals without an earlier Huffman table")
    table = frame.huffman
    if size_format == 0:
        streams = [(section[q:], regen)]
    else:
        s1, s2, s3 = (int.from_bytes(section[q + 2 * i:q + 2 * i + 2], "little")
                      for i in range(3))
        q += 6
        each = (regen + 3) // 4
        last = regen - 3 * each
        cuts = [q, q + s1, q + s1 + s2, q + s1 + s2 + s3, size]
        if last < 0 or cuts[3] > size:
            raise _corrupt("Huffman jump table")
        streams = [(section[cuts[i]:cuts[i + 1]], each if i < 3 else last)
                   for i in range(4)]
    ids = []
    for stream, count in streams:
        if count == 0:
            continue
        ids.append(len(jobs))
        jobs.append((stream, table, count))
    return ids, p + size


def _sequence_table(kind: str, mode: int, data: bytes, p: int,
                    frame: _Frame):
    if mode == 0:
        counts, log = {"ll": _LL_DEFAULT, "of": _OF_DEFAULT,
                       "ml": _ML_DEFAULT}[kind]
        table = _Fse.from_counts(counts, log)
    elif mode == 1:
        table = _Fse.rle(data[p])
        p += 1
    elif mode == 2:
        counts, log, used = _read_fse_description(data[p:p + 512],
                                                  _MAX_LOG[kind])
        table = _Fse.from_counts(counts, log)
        p += used
    else:
        table = frame.tables[kind]
        if table is None:
            raise _corrupt(f"repeat {kind} table without an earlier one")
    frame.tables[kind] = table
    return table, p


def _parse_sequences(data: bytes, p: int, end: int, frame: _Frame):
    b0 = data[p]
    if b0 == 0:
        return [], p + 1
    if b0 < 128:
        nseq, p = b0, p + 1
    elif b0 < 255:
        nseq, p = ((b0 - 128) << 8) + data[p + 1], p + 2
    else:
        nseq, p = data[p + 1] + (data[p + 2] << 8) + 0x7F00, p + 3
    modes = data[p]
    p += 1
    if modes & 3:
        raise _corrupt("reserved bits of the sequence modes")
    ll, p = _sequence_table("ll", modes >> 6, data, p, frame)
    of, p = _sequence_table("of", (modes >> 4) & 3, data, p, frame)
    ml, p = _sequence_table("ml", (modes >> 2) & 3, data, p, frame)
    if p >= end:
        raise _corrupt("sequences without a bitstream")
    bits = _Backward(data[p:end])
    ls, os_, ms = bits.read(ll.log), bits.read(of.log), bits.read(ml.log)
    rep = frame.rep
    seqs = []
    for i in range(nseq):
        of_code, ll_code, ml_code = of.symbol[os_], ll.symbol[ls], ml.symbol[ms]
        if of_code > 31 or ll_code >= len(_LL) or ml_code >= len(_ML):
            raise _corrupt("sequence code out of range")
        of_val = (1 << of_code) + bits.read(of_code)
        mb, mx = _ML[ml_code]
        mlen = mb + bits.read(mx)
        lb, lx = _LL[ll_code]
        llen = lb + bits.read(lx)
        if of_val > 3:
            off = of_val - 3
            rep = [off, rep[0], rep[1]]
        else:
            idx = of_val - 1 + (llen == 0)
            if idx == 0:
                off = rep[0]
            elif idx == 3:
                off = rep[0] - 1
                rep = [off, rep[0], rep[1]]
            else:
                off = rep[idx]
                rep = [off, rep[0], rep[2 if idx == 1 else 1]]
        if off <= 0:
            raise _corrupt("zero offset")
        seqs.append((llen, mlen, off))
        if i + 1 < nseq:
            ls = ll.base[ls] + bits.read(ll.nbits[ls])
            ms = ml.base[ms] + bits.read(ml.nbits[ms])
            os_ = of.base[os_] + bits.read(of.nbits[os_])
    if not bits.exhausted():
        raise _corrupt("sequence bitstream not consumed exactly")
    frame.rep = rep
    return seqs, end


def _parse_frame(data: bytes, p: int, jobs: list):
    """(frame plan, end of the frame)."""
    if len(data) - p < 6:
        raise _corrupt("truncated frame header")
    if int.from_bytes(data[p:p + 4], "little") != FRAME_MAGIC:
        raise ValueError("zstd: not a zstd frame (bad magic number)")
    fhd = data[p + 4]
    p += 5
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    if fhd & 8:
        raise _corrupt("reserved frame header bit set")
    has_checksum, dict_flag = (fhd >> 2) & 1, fhd & 3
    if not single:
        p += 1  # window descriptor
    dsize = (0, 1, 2, 4)[dict_flag]
    dict_id = int.from_bytes(data[p:p + dsize], "little")
    p += dsize
    if dict_id:
        raise ValueError(f"zstd: the frame needs dictionary {dict_id}; "
                         "dictionaries are not supported")
    frame = _Frame()
    fsize = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if fsize:
        frame.content_size = (int.from_bytes(data[p:p + fsize], "little")
                              + (256 if fsize == 2 else 0))
        p += fsize
    while True:
        if p + 3 > len(data):
            raise _corrupt("truncated block header")
        head = int.from_bytes(data[p:p + 3], "little")
        p += 3
        last, btype, bsize = head & 1, (head >> 1) & 3, head >> 3
        if btype == 0:
            chunk = data[p:p + bsize]
            if len(chunk) != bsize:
                raise _corrupt("truncated raw block")
            frame.blocks.append(("bytes", chunk))
            p += bsize
        elif btype == 1:
            if p >= len(data):
                raise _corrupt("truncated RLE block")
            frame.blocks.append(("bytes", bytes(data[p:p + 1]) * bsize))
            p += 1
        elif btype == 2:
            end = p + bsize
            if end > len(data):
                raise _corrupt("truncated compressed block")
            lits, q = _parse_literals(data, p, frame, jobs)
            if q > end:
                raise _corrupt("literals overrun the block")
            seqs, q = (_parse_sequences(data, q, end, frame) if q < end
                       else ([], q))
            if q != end:
                raise _corrupt("sequences section size")
            frame.blocks.append(("seq", lits, seqs))
            p = end
        else:
            raise _corrupt("reserved block type")
        if last:
            break
    if has_checksum:
        if p + 4 > len(data):
            raise _corrupt("truncated checksum")
        frame.checksum = int.from_bytes(data[p:p + 4], "little")
        p += 4
    return frame, p


def _execute(frame: _Frame, literals: List[bytes]) -> bytes:
    out = bytearray()
    for block in frame.blocks:
        if block[0] == "bytes":
            out += block[1]
            continue
        _, lits, seqs = block
        if isinstance(lits, list):
            lits = b"".join(literals[j] for j in lits)
        lp = 0
        for llen, mlen, off in seqs:
            if lp + llen > len(lits):
                raise _corrupt("sequence reads past its literals")
            out += lits[lp:lp + llen]
            lp += llen
            start = len(out) - off
            if start < 0:
                raise _corrupt("match offset before the frame's start")
            if off >= mlen:
                out += out[start:start + mlen]
            else:
                piece = bytes(out[start:])
                out += (piece * (mlen // off + 1))[:mlen]
        out += lits[lp:]
    data = bytes(out)
    if frame.content_size is not None and len(data) != frame.content_size:
        raise _corrupt("frame content size")
    if frame.checksum is not None and \
            xxh64(data) & 0xFFFFFFFF != frame.checksum:
        raise ValueError("zstd: content checksum mismatch")
    return data


def decompress_many(buffers: Sequence[bytes]) -> List[bytes]:
    """Each buffer (one or more frames back to back) decompressed; the
    Huffman literals of every buffer decode in one batch."""
    jobs: list = []
    plans = []
    for data in buffers:
        data = bytes(data)
        frames, p = [], 0
        if not data:
            raise ValueError("zstd: empty input")
        while p < len(data):
            frame, p = _parse_frame(data, p, jobs)
            frames.append(frame)
        plans.append(frames)
    literals = _decode_huffman(jobs)
    return [b"".join(_execute(f, literals) for f in frames)
            for frames in plans]


def decompress(data: bytes) -> bytes:
    """One buffer of zstd frames, decompressed."""
    return decompress_many([data])[0]
