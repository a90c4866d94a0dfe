"""Zstandard frame decoder (RFC 8878), in Python: a decoder only.

Orbax's checkpoints compress every zarr chunk, and the OCDBT store every
manifest and B-tree node, with zstd; the card's machine has no zstd
package, so the port reads them with this module.

It covers raw, RLE and compressed blocks; raw, RLE, Huffman (1 or 4
streams) and treeless literals; predefined, RLE, FSE-coded and repeated
sequence tables, with the repeat offsets carried across blocks; multi-block
frames with or without ``Frame_Content_Size``; the XXH64 content checksum,
verified where the frame has one. A frame that names a dictionary raises,
and so does every malformed input: ``ZstdError``.
"""

from __future__ import annotations

MAGIC = 0xFD2FB528
_BLOCK_MAX = 128 * 1024

# literal-length and match-length codes: (baseline, number of extra bits)
_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096,
                              8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
                                 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]

# predefined distributions (RFC 8878 3.1.1.3.2.2) and the most a frame may use
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
                -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
_LL_MAX = (35, 9)  # (largest symbol, largest accuracy log)
_OF_MAX = (31, 8)
_ML_MAX = (52, 9)


class ZstdError(ValueError):
    """A malformed, truncated or unsupported zstd frame."""


# ---------------------------------------------------------------------------
# XXH64 (the frame's content checksum keeps its low 32 bits)
_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data`."""
    n = len(data)
    mv = memoryview(data)
    p = 0
    if n >= 32:
        v1, v2, v3, v4 = (seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64
        lanes = mv[: n - n % 32].cast("Q")
        for i in range(0, len(lanes), 4):
            v1 = _round(v1, lanes[i])
            v2 = _round(v2, lanes[i + 1])
            v3 = _round(v3, lanes[i + 2])
            v4 = _round(v4, lanes[i + 3])
        p = n - n % 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h = (_rotl(h ^ _round(0, int.from_bytes(mv[p:p + 8], "little")), 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h = (_rotl(h ^ ((int.from_bytes(mv[p:p + 4], "little") * _P1) & _M64), 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h = (_rotl(h ^ ((mv[p] * _P5) & _M64), 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# ---------------------------------------------------------------------------
# bit streams
def _backward_start(buf: bytes, start: int, end: int) -> int:
    """The number of bits of the backward stream buf[start:end] below its
    padding marker (the highest set bit of its last byte)."""
    if end <= start:
        raise ZstdError("empty backward bit stream")
    last = buf[end - 1]
    if last == 0:
        raise ZstdError("backward bit stream without its padding bit")
    return (end - start - 1) * 8 + last.bit_length() - 1


def _bits(buf: bytes, start: int, p: int, n: int) -> int:
    """Bits [p, p + n) of the stream that begins at byte `start` (bit 0 is
    the low bit of its first byte); bits below the stream's start read as 0."""
    if p >= 0:
        b = start + (p >> 3)
        return (int.from_bytes(buf[b:b + 8], "little") >> (p & 7)) & ((1 << n) - 1)
    if p + n <= 0:
        return 0
    return (int.from_bytes(buf[start:start + 8], "little") << -p) & ((1 << n) - 1)


# ---------------------------------------------------------------------------
# FSE
def _read_fse_description(buf: bytes, pos: int, end: int, max_symbol: int, max_log: int):
    """(normalized counts, accuracy log, bytes read) of the FSE table
    description at buf[pos:end] (RFC 8878 4.1.1)."""
    if pos >= end:
        raise ZstdError("truncated FSE table description")
    log = (buf[pos] & 15) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above {max_log}")
    bit = 4
    limit = (end - pos) * 8
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: list[int] = []
    previous0 = False
    while remaining > 1 and len(counts) <= max_symbol:
        if previous0:
            while True:
                if bit + 2 > limit:
                    raise ZstdError("truncated FSE table description")
                rep = _bits(buf, pos, bit, 2)
                bit += 2
                counts.extend([0] * rep)
                if rep != 3:
                    break
            if len(counts) > max_symbol:
                raise ZstdError("FSE table description runs past its symbols")
        v = _bits(buf, pos, bit, nbits)
        big = (2 * threshold - 1) - remaining
        if (v & (threshold - 1)) < big:
            count = v & (threshold - 1)
            bit += nbits - 1
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= big
            bit += nbits
        if bit > limit:
            raise ZstdError("truncated FSE table description")
        count -= 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        previous0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError("FSE table description does not sum to its table size")
    return counts, log, (bit + 7) >> 3


def _fse_table(counts: list[int], log: int):
    """(symbol, number of bits, baseline) lists of the decoding table of a
    normalized distribution (RFC 8878 4.1.1)."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = list(counts)
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    p = 0
    for s, c in enumerate(counts):
        for _ in range(c if c > 0 else 0):
            sym[p] = s
            p = (p + step) & mask
            while p > high:
                p = (p + step) & mask
    if p != 0:
        raise ZstdError("FSE distribution does not fill its table")
    nb = [0] * size
    base = [0] * size
    for u in range(size):
        s = sym[u]
        x = nxt[s]
        nxt[s] = x + 1
        n = log - (x.bit_length() - 1)
        nb[u] = n
        base[u] = (x << n) - size
    return sym, nb, base, log


def _rle_table(symbol: int):
    return [symbol], [0], [0], 0


_LL_PREDEFINED = _fse_table(*_LL_DEFAULT)
_ML_PREDEFINED = _fse_table(*_ML_DEFAULT)
_OF_PREDEFINED = _fse_table(*_OF_DEFAULT)


# ---------------------------------------------------------------------------
# Huffman
def _huffman_weights_fse(buf: bytes, pos: int, end: int) -> list[int]:
    """The FSE-coded Huffman weights in buf[pos:end]: two interleaved states
    on one table, read until the stream is spent (RFC 8878 4.2.1.2)."""
    counts, log, hdr = _read_fse_description(buf, pos, end, 255, 6)
    sym, nb, base, _ = _fse_table(counts, log)
    start = pos + hdr
    p = _backward_start(buf, start, end)
    p -= log
    s1 = _bits(buf, start, p, log)
    p -= log
    s2 = _bits(buf, start, p, log)
    if p < 0:
        raise ZstdError("Huffman weight stream shorter than its states")
    out: list[int] = []
    while True:
        out.append(sym[s1])
        n = nb[s1]
        p -= n
        s1 = base[s1] + _bits(buf, start, p, n)
        if p < 0:
            out.append(sym[s2])
            break
        out.append(sym[s2])
        n = nb[s2]
        p -= n
        s2 = base[s2] + _bits(buf, start, p, n)
        if p < 0:
            out.append(sym[s1])
            break
        if len(out) > 255:
            raise ZstdError("too many Huffman weights")
    return out


def _read_huffman_table(buf: bytes, pos: int, end: int):
    """((symbol, number of bits) lists indexed by the next `max_bits` bits,
    max_bits) of the Huffman tree description at buf[pos:], and its size."""
    if pos >= end:
        raise ZstdError("truncated Huffman tree description")
    head = buf[pos]
    if head < 128:
        if pos + 1 + head > end:
            raise ZstdError("truncated Huffman tree description")
        weights = _huffman_weights_fse(buf, pos + 1, pos + 1 + head)
        size = 1 + head
    else:
        n = head - 127
        size = 1 + (n + 1) // 2
        if pos + size > end:
            raise ZstdError("truncated Huffman tree description")
        weights = [(buf[pos + 1 + i // 2] >> (0 if i & 1 else 4)) & 15 for i in range(n)]
    if len(weights) > 255:
        raise ZstdError("too many Huffman weights")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("Huffman weights all zero")
    max_bits = total.bit_length()
    if max_bits > 11:
        raise ZstdError(f"Huffman code of {max_bits} bits")
    left = (1 << max_bits) - total
    if left & (left - 1):
        raise ZstdError("Huffman weights do not complete a code")
    weights.append(left.bit_length())
    sym: list[int] = []
    nbits: list[int] = []
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                sym.extend([s] * (1 << (w - 1)))
                nbits.extend([max_bits + 1 - w] * (1 << (w - 1)))
    return (sym, nbits, max_bits), size


def _huffman_stream(buf: bytes, start: int, end: int, n_out: int, table, out: bytearray) -> None:
    """Append the `n_out` literals of the Huffman stream buf[start:end]."""
    sym, nbits, mb = table
    p = _backward_start(buf, start, end)
    mask = (1 << mb) - 1
    frm = int.from_bytes
    for _ in range(n_out):
        q = p - mb
        if q >= 0:
            b = start + (q >> 3)
            v = (frm(buf[b:b + 3], "little") >> (q & 7)) & mask
        else:
            v = (frm(buf[start:start + 3], "little") << -q) & mask
        out.append(sym[v])
        p -= nbits[v]
    if p != 0:
        raise ZstdError("Huffman stream not consumed exactly")


# ---------------------------------------------------------------------------
class _Frame:
    """The state that a frame carries from block to block."""

    def __init__(self):
        self.out = bytearray()
        self.huffman = None
        self.tables = [None, None, None]  # literal lengths, offsets, match lengths
        self.rep = [1, 4, 8]


def _literals(buf: bytes, pos: int, end: int, frame: _Frame):
    """(literals, position after the literals section)."""
    b0 = buf[pos]
    kind = b0 & 3
    fmt = (b0 >> 2) & 3
    if kind < 2:
        if fmt in (0, 2):
            n, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            n, pos = (b0 >> 4) + (buf[pos + 1] << 4), pos + 2
        else:
            n, pos = (b0 >> 4) + (buf[pos + 1] << 4) + (buf[pos + 2] << 12), pos + 3
        if kind == 0:
            if pos + n > end:
                raise ZstdError("truncated raw literals")
            return bytes(buf[pos:pos + n]), pos + n
        if pos >= end:
            raise ZstdError("truncated RLE literals")
        return bytes([buf[pos]]) * n, pos + 1
    hdr = 3 if fmt < 2 else fmt + 2
    if pos + hdr > end:
        raise ZstdError("truncated literals header")
    v = int.from_bytes(buf[pos:pos + hdr], "little")
    width = (10, 10, 14, 18)[fmt]
    regen = (v >> 4) & ((1 << width) - 1)
    comp = (v >> (4 + width)) & ((1 << width) - 1)
    pos += hdr
    stop = pos + comp
    if stop > end:
        raise ZstdError("truncated compressed literals")
    if kind == 2:
        frame.huffman, used = _read_huffman_table(buf, pos, stop)
        pos += used
    elif frame.huffman is None:
        raise ZstdError("treeless literals with no earlier Huffman table")
    out = bytearray()
    if fmt == 0:
        _huffman_stream(buf, pos, stop, regen, frame.huffman, out)
    else:
        if pos + 6 > stop:
            raise ZstdError("truncated jump table")
        s1, s2, s3 = (int.from_bytes(buf[pos + 2 * i:pos + 2 * i + 2], "little") for i in range(3))
        pos += 6
        each = (regen + 3) // 4
        bounds = [pos, pos + s1, pos + s1 + s2, pos + s1 + s2 + s3, stop]
        if bounds[3] > stop:
            raise ZstdError("jump table runs past the literals")
        for i in range(4):
            _huffman_stream(buf, bounds[i], bounds[i + 1], each if i < 3 else regen - 3 * each,
                            frame.huffman, out)
    if len(out) != regen:
        raise ZstdError("Huffman literals of the wrong size")
    return bytes(out), stop


def _sequence_table(mode: int, which: int, buf: bytes, pos: int, end: int, frame: _Frame):
    """(table, bytes read) of one of the three sequence codes."""
    if mode == 0:
        table = (_LL_PREDEFINED, _OF_PREDEFINED, _ML_PREDEFINED)[which]
        used = 0
    elif mode == 1:
        if pos >= end:
            raise ZstdError("truncated RLE sequence table")
        if buf[pos] > (_LL_MAX, _OF_MAX, _ML_MAX)[which][0]:
            raise ZstdError("RLE sequence code out of range")
        table, used = _rle_table(buf[pos]), 1
    elif mode == 2:
        max_symbol, max_log = (_LL_MAX, _OF_MAX, _ML_MAX)[which]
        counts, log, used = _read_fse_description(buf, pos, end, max_symbol, max_log)
        table = _fse_table(counts, log)
    else:
        table, used = frame.tables[which], 0
        if table is None:
            raise ZstdError("repeated sequence table with no earlier table")
    frame.tables[which] = table
    return table, used


def _compressed_block(buf: bytes, pos: int, end: int, frame: _Frame) -> None:
    lits, pos = _literals(buf, pos, end, frame)
    out = frame.out
    if pos >= end:
        raise ZstdError("truncated sequences section")
    b0 = buf[pos]
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + buf[pos + 1], pos + 2
    else:
        nseq, pos = buf[pos + 1] + (buf[pos + 2] << 8) + 0x7F00, pos + 3
    if nseq == 0:
        if pos != end:
            raise ZstdError("bytes after a block without sequences")
        out += lits
        return
    if pos >= end:
        raise ZstdError("truncated sequences section")
    modes = buf[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence modes")
    tables = []
    for which, shift in ((0, 6), (1, 4), (2, 2)):
        table, used = _sequence_table((modes >> shift) & 3, which, buf, pos, end, frame)
        tables.append(table)
        pos += used
    (ll_sym, ll_nb, ll_base, ll_log), (of_sym, of_nb, of_base, of_log), (ml_sym, ml_nb, ml_base, ml_log) = tables
    start = pos
    p = _backward_start(buf, start, end)
    p -= ll_log + of_log + ml_log
    v = _bits(buf, start, p, ll_log + of_log + ml_log)
    s_ml = v & ((1 << ml_log) - 1)
    s_of = (v >> ml_log) & ((1 << of_log) - 1)
    s_ll = v >> (ml_log + of_log)
    frm = int.from_bytes
    r1, r2, r3 = frame.rep
    lp = 0
    for i in range(nseq):
        # one read of the sequence's bits: at most 31 + 16 + 16 of its codes
        # and 9 + 9 + 8 of the state updates, below p
        q = p - 96
        if q >= 0:
            b = start + (q >> 3)
            w = frm(buf[b:b + 13], "little") >> (q & 7)
        else:
            w = frm(buf[start:start + 13], "little") << -q
        of_code, ll_code, ml_code = of_sym[s_of], ll_sym[s_ll], ml_sym[s_ml]
        p -= of_code
        ofv = (1 << of_code) + ((w >> (p - q)) & ((1 << of_code) - 1))
        n = _ML_BITS[ml_code]
        p -= n
        ml = _ML_BASE[ml_code] + ((w >> (p - q)) & ((1 << n) - 1))
        n = _LL_BITS[ll_code]
        p -= n
        ll = _LL_BASE[ll_code] + ((w >> (p - q)) & ((1 << n) - 1))
        if i != nseq - 1:
            n = ll_nb[s_ll]
            p -= n
            s_ll = ll_base[s_ll] + ((w >> (p - q)) & ((1 << n) - 1))
            n = ml_nb[s_ml]
            p -= n
            s_ml = ml_base[s_ml] + ((w >> (p - q)) & ((1 << n) - 1))
            n = of_nb[s_of]
            p -= n
            s_of = of_base[s_of] + ((w >> (p - q)) & ((1 << n) - 1))
        if ofv > 3:
            off = ofv - 3
            r1, r2, r3 = off, r1, r2
        else:
            idx = ofv if ll else ofv + 1
            if idx == 1:
                off = r1
            elif idx == 2:
                off = r2
                r1, r2 = r2, r1
            elif idx == 3:
                off = r3
                r1, r2, r3 = r3, r1, r2
            else:
                off = r1 - 1
                if off == 0:
                    raise ZstdError("repeat offset of 0")
                r1, r2, r3 = off, r1, r2
        if ll:
            if lp + ll > len(lits):
                raise ZstdError("sequence runs past its literals")
            out += lits[lp:lp + ll]
            lp += ll
        src = len(out) - off
        if src < 0:
            raise ZstdError("match offset before the start of the frame")
        if off >= ml:
            out += out[src:src + ml]
        else:
            chunk = out[src:]
            out += (chunk * (ml // off + 1))[:ml]
    if p != 0:
        raise ZstdError("sequence bit stream not consumed exactly")
    frame.rep = [r1, r2, r3]
    out += lits[lp:]


def _frame(buf: bytes, pos: int):
    """(decoded frame, position after it) of the frame at buf[pos]."""
    n = len(buf)
    if pos + 5 > n:
        raise ZstdError("truncated frame header")
    fhd = buf[pos + 4]
    pos += 5
    fcs_flag, single, checksum, did_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("reserved bit set in the frame header")
    if not single:
        pos += 1  # window descriptor: the whole frame is kept, so its size is not needed
    did_size = (0, 1, 2, 4)[did_flag]
    if did_size and int.from_bytes(buf[pos:pos + did_size], "little"):
        raise ZstdError("frames that need a dictionary are not supported")
    pos += did_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content_size = None
    if fcs_size:
        content_size = int.from_bytes(buf[pos:pos + fcs_size], "little") + (256 if fcs_size == 2 else 0)
    pos += fcs_size
    if pos > n:
        raise ZstdError("truncated frame header")
    frame = _Frame()
    while True:
        if pos + 3 > n:
            raise ZstdError("truncated block header")
        h = buf[pos] | (buf[pos + 1] << 8) | (buf[pos + 2] << 16)
        pos += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 1:
            if pos >= n:
                raise ZstdError("truncated RLE block")
            frame.out += bytes([buf[pos]]) * size
            pos += 1
        else:
            if size > _BLOCK_MAX:
                raise ZstdError(f"block of {size} bytes")
            if pos + size > n:
                raise ZstdError("truncated block")
            if kind == 0:
                frame.out += buf[pos:pos + size]
            elif kind == 2:
                _compressed_block(buf, pos, pos + size, frame)
            else:
                raise ZstdError("reserved block type")
            pos += size
        if last:
            break
    out = frame.out
    if content_size is not None and len(out) != content_size:
        raise ZstdError(f"frame content size {content_size}, decoded {len(out)}")
    if checksum:
        if pos + 4 > n:
            raise ZstdError("truncated content checksum")
        if int.from_bytes(buf[pos:pos + 4], "little") != xxh64(bytes(out)) & 0xFFFFFFFF:
            raise ZstdError("content checksum mismatch")
        pos += 4
    return out, pos


def decompress(data: bytes) -> bytes:
    """The content of the zstd frames in `data` (one or more, back to back)."""
    buf = bytes(data)
    pos = 0
    out = bytearray()
    if not buf:
        raise ZstdError("no zstd frame")
    while pos < len(buf):
        if pos + 4 > len(buf):
            raise ZstdError("truncated frame magic")
        magic = int.from_bytes(buf[pos:pos + 4], "little")
        if magic != MAGIC:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
        part, pos = _frame(buf, pos)
        out += part
    return bytes(out)
