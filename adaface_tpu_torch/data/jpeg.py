"""A JPEG decoder on numpy and the standard library, so that the port reads
JPEGs where PIL is missing (the card's machine has none).

`decode(data)` gives the pixels that libjpeg-turbo gives Pillow, bit for
bit, so `load(src, mode)` equals `np.asarray(Image.open(src).convert(mode))`.
It follows that library's decode arithmetic, not an approximation of it:

- entropy decoding: Huffman (`jdhuff.c`, `jdphuff.c`) of sequential
  (SOF0, SOF1) and progressive (SOF2: DC first and refine, AC first and
  refine with EOB runs) 8-bit frames, restart intervals (DRI, RST0-7: the
  DC predictors and the EOB run reset, the bit reader realigns);
- the integer "islow" IDCT (`jidctint.c`: CONST_BITS 13, PASS1_BITS 2, its
  descale rounding, and its `range_limit` table, which wraps modulo 1024
  before it clamps);
- "fancy" (triangle) upsampling of h2v1 and h2v2 chroma (`jdsample.c`, its
  alternating biases +1/+2 and +8/+7, edges by the component's downsampled
  width and height, the last real row repeated below); a component at most
  2 samples wide takes the plain box upsampling, as libjpeg does;
- YCbCr to RGB through `jdcolor.c`'s fixed-point tables (SCALEBITS 16).

Colour space by libjpeg's rules (`jdapimin.c`): a JFIF file or component
ids 1, 2, 3 is YCbCr; an Adobe marker with transform 0, or ids 'R', 'G',
'B', is RGB and is not converted. Files it does not take raise
`UnsupportedJPEG`, naming the feature: arithmetic coding, 12- or 16-bit
samples, lossless or hierarchical frames, four components, sampling other
than 4:4:4, 4:2:2 or 4:2:0 (luma h, v in {1, 2}, chroma 1x1), a progressive
file whose scans leave a coefficient's bits unsent (there libjpeg's block
smoothing changes the pixels), and a truncated file.

The Huffman decoding is the only per-symbol Python: a lookahead table
indexed by the next LOOKAHEAD bits gives a code's length, run and value at
once (the canonical code search of `jdhuff.c` serves the longer codes).
Dequantisation, IDCT, upsampling and colour conversion run vectorised over
every block of a component.
"""

from __future__ import annotations

import functools
import re
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

SOI = b"\xff\xd8\xff"
LOOKAHEAD = 12  # bits of the table lookup
_SHIFT = 32 - LOOKAHEAD

# zigzag index -> natural (row-major) index, `jpeg_natural_order`
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22,
    15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55,
    62, 63])

_UNSUPPORTED_SOF = {0xC3: "lossless JPEG", 0xC5: "hierarchical JPEG",
                    0xC6: "hierarchical JPEG", 0xC7: "hierarchical JPEG",
                    0xC9: "arithmetic-coded JPEG", 0xCA: "arithmetic-coded JPEG",
                    0xCB: "arithmetic-coded JPEG", 0xCD: "arithmetic-coded JPEG",
                    0xCE: "arithmetic-coded JPEG", 0xCF: "arithmetic-coded JPEG"}
# a marker that ends an entropy-coded segment: FF, then neither a stuffed 00,
# nor RST0-7, nor another FF (fill)
_END_OF_SCAN = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")
_RST = re.compile(rb"\xff[\xd0-\xd7]")
_M32 = 0xFFFFFFFF


class UnsupportedJPEG(ValueError):
    """A JPEG this decoder does not take (PIL still may); `feature` names it."""

    def __init__(self, feature: str):
        super().__init__(feature)
        self.feature = feature


def _corrupt(what: str) -> UnsupportedJPEG:
    return UnsupportedJPEG(f"corrupt JPEG data: {what}")


# ------------------------------------------------------------- Huffman tables

@functools.lru_cache(maxsize=64)
def _huffman(spec: bytes, dc: bool):
    """(fast, code, maxcode, valoffset, values) of one DHT table: `spec` is
    its 16 counts and its symbols. fast[x] for the next LOOKAHEAD bits x is
    (bits, value) (DC) or (bits, run, value) (AC; run -1 ends the block)
    where the code and its value bits fit, else None; code[x] is (length,
    symbol) where the code fits, else None; the rest serves the canonical
    search."""
    counts, values = list(spec[:16]), list(spec[16:])
    if sum(counts) != len(values) or len(values) > 256:
        raise _corrupt("bad Huffman table")
    lengths = np.repeat(np.arange(1, 17), counts)
    maxcode, valoffset = [-1] * 18, [0] * 18
    code, k = 0, 0
    for n in range(1, 17):
        valoffset[n] = k - code
        code += counts[n - 1]
        k += counts[n - 1]
        maxcode[n] = code - 1 if counts[n - 1] else -1
        if code > (1 << n):
            raise _corrupt("bad Huffman table")
        code <<= 1
    maxcode[17] = 1 << 40  # a sentinel: no code is longer than 16 bits
    la = LOOKAHEAD
    fits = lengths <= la
    span = 1 << (la - lengths[fits])
    n_of = np.zeros(1 << la, np.int64)
    sym_of = np.zeros(1 << la, np.int64)
    filled = int(span.sum())
    n_of[:filled] = np.repeat(lengths[fits], span)
    sym_of[:filled] = np.repeat(np.asarray(values, np.int64)[:len(lengths)][fits], span)
    x = np.arange(1 << la)
    s = sym_of & 15
    run = sym_of >> 4
    room = la - n_of - s
    ok = (n_of > 0) & (room >= 0)
    bits = (x >> np.maximum(room, 0)) & ((1 << s) - 1)
    v = np.where(bits < (1 << np.maximum(s - 1, 0)), bits - (1 << s) + 1, bits)
    v = np.where(s == 0, 0, v)
    total = n_of + s
    code_tab = [(int(a), int(b)) if a else None for a, b in zip(n_of, sym_of)]
    if dc:
        fast = [(int(t), int(val)) if o else None for t, val, o in zip(total, v, ok)]
    else:
        # baseline AC: (r < 15, s = 0) ends the block, ZRL writes a zero 15 on
        runs = np.where(s == 0, np.where(run == 15, 15, -1), run)
        fast = [(int(t), int(r), int(val)) if o else None
                for t, r, val, o in zip(total, runs, v, ok)]
    return fast, code_tab, maxcode, valoffset, values


def _code(tab, w: int) -> Tuple[int, int]:
    """(length, symbol) of the code at the top of the 32-bit window w."""
    hit = tab[1][w >> (32 - LOOKAHEAD)]
    if hit is not None:
        return hit
    maxcode, valoffset, values = tab[2], tab[3], tab[4]
    n = LOOKAHEAD + 1
    code = w >> (32 - n)
    while code > maxcode[n]:
        n += 1
        code = w >> (32 - n)
    if n > 16:
        raise _corrupt("bad Huffman code")
    return n, values[valoffset[n] + code]


def _value(w: int, skip: int, s: int) -> int:
    """The s-bit value after `skip` bits of the window, sign-extended
    (`HUFF_EXTEND`)."""
    if s == 0:
        return 0
    x = ((w << skip) & _M32) >> (32 - s)
    return x - (1 << s) + 1 if x < (1 << (s - 1)) else x


def _slow_dc(tab, w):
    n, s = _code(tab, w)
    return n + s, _value(w, n, s)


def _slow_ac(tab, w):
    n, sym = _code(tab, w)
    r, s = sym >> 4, sym & 15
    if s == 0:
        return n, (15 if r == 15 else -1), 0
    return n + s, r, _value(w, n, s)


# --------------------------------------------------------------- bit windows

def _windows(data: bytes):
    """The 32 bits that start at each bit of `data` (then zeros), as a
    memoryview of uint32: window[p] is an int in one index."""
    b = np.frombuffer(data + b"\x00" * 16, np.uint8).astype(np.uint64)
    n = len(data) + 8
    v = (b[:n] << 32) | (b[1:n + 1] << 24) | (b[2:n + 2] << 16) | (b[3:n + 3] << 8) | b[4:n + 4]
    w = np.empty((n, 8), np.uint32)
    for j in range(8):
        w[:, j] = v >> np.uint64(8 - j)  # the cast keeps the low 32 bits
    return memoryview(w.reshape(-1))


def _segments(data: bytes, pos: int):
    """The entropy-coded data of a scan from `pos`: (windows, start bit of
    each restart interval, its end bit, the position of the marker after)."""
    m = _END_OF_SCAN.search(data, pos)
    end = m.start() if m else len(data)
    parts = [p.rstrip(b"\xff").replace(b"\xff\x00", b"\xff")
             for p in _RST.split(data[pos:end])]
    starts, ends, at = [], [], 0
    for p in parts:
        starts.append(at)
        at += 8 * len(p)
        ends.append(at)
    return _windows(b"".join(parts)), starts, ends, end


# ------------------------------------------------------------- scan decoders

def _intervals(nblocks: int, per_mcu: int, restart: int, starts, ends):
    """(first block, end block, start bit, end bit) of each restart interval."""
    per = restart * per_mcu if restart else nblocks
    out = []
    for i, b0 in enumerate(range(0, nblocks, per)):
        if i >= len(starts):
            raise UnsupportedJPEG("truncated JPEG")
        out.append((b0, min(b0 + per, nblocks), starts[i], ends[i]))
    return out


def _sequential(W, spans, C, blocks, comps, dcs, acs, ncomp):
    """Baseline / extended sequential: every coefficient of each block."""
    sh = _SHIFT
    for b0, b1, p, end in spans:
        pred = [0] * ncomp
        for j in range(b0, b1):
            base, ci = blocks[j], comps[j]
            dtab, atab = dcs[ci], acs[ci]
            w = W[p]
            t = dtab[0][w >> sh]
            if t is None:
                t = _slow_dc(dtab, w)
            n, v = t
            p += n
            pred[ci] += v
            C[base] = pred[ci]
            fast = atab[0]
            k = 1
            while k < 64:
                w = W[p]
                t = fast[w >> sh]
                if t is None:
                    t = _slow_ac(atab, w)
                n, r, v = t
                p += n
                if r < 0:
                    break
                k += r
                C[base + k] = v
                k += 1
            if k > 64:
                raise _corrupt("coefficient index past 63")
        if p > end:
            raise UnsupportedJPEG("truncated JPEG")


def _dc_first(W, spans, C, blocks, comps, dcs, ncomp, al):
    sh = _SHIFT
    for b0, b1, p, end in spans:
        pred = [0] * ncomp
        for j in range(b0, b1):
            ci = comps[j]
            dtab = dcs[ci]
            w = W[p]
            t = dtab[0][w >> sh]
            if t is None:
                t = _slow_dc(dtab, w)
            n, v = t
            p += n
            pred[ci] += v
            C[blocks[j]] = pred[ci] << al
        if p > end:
            raise UnsupportedJPEG("truncated JPEG")


def _dc_refine(W, spans, C, blocks, al):
    p1 = 1 << al
    for b0, b1, p, end in spans:
        for j in range(b0, b1):
            if W[p] >> 31:
                C[blocks[j]] |= p1
            p += 1
        if p > end:
            raise UnsupportedJPEG("truncated JPEG")


def _ac_first(W, spans, C, blocks, tab, ss, se, al):
    """`decode_mcu_AC_first`: one band of one component, EOB runs."""
    for b0, b1, p, end in spans:
        eobrun = 0
        for j in range(b0, b1):
            if eobrun:
                eobrun -= 1
                continue
            base = blocks[j]
            k = ss
            while k <= se:
                w = W[p]
                n, sym = _code(tab, w)
                p += n
                r, s = sym >> 4, sym & 15
                if s:
                    k += r
                    C[base + k] = _value(w, n, s) << al
                    p += s
                elif r == 15:
                    k += 15
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += W[p] >> (32 - r)
                        p += r
                    eobrun -= 1
                    break
                k += 1
            if k > 64:
                raise _corrupt("coefficient index past 63")
        if p > end:
            raise UnsupportedJPEG("truncated JPEG")


def _ac_refine(W, spans, C, blocks, tab, ss, se, al):
    """`decode_mcu_AC_refine`: correction bits for the coefficients already
    nonzero, newly nonzero ones at +-2^al, EOB runs."""
    p1, m1 = 1 << al, -(1 << al)
    for b0, b1, p, end in spans:
        eobrun = 0
        for j in range(b0, b1):
            base = blocks[j]
            k = ss
            if eobrun == 0:
                while k <= se:
                    w = W[p]
                    n, sym = _code(tab, w)
                    p += n
                    r, s = sym >> 4, sym & 15
                    if s:
                        s = p1 if W[p] >> 31 else m1
                        p += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += W[p] >> (32 - r)
                            p += r
                        break
                    while k <= se:
                        i = base + k
                        c = C[i]
                        if c:
                            if W[p] >> 31 and not c & p1:
                                C[i] = c + p1 if c >= 0 else c + m1
                            p += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s:
                        C[base + k] = s
                    k += 1
            if eobrun > 0:
                while k <= se:
                    i = base + k
                    c = C[i]
                    if c:
                        if W[p] >> 31 and not c & p1:
                            C[i] = c + p1 if c >= 0 else c + m1
                        p += 1
                    k += 1
                eobrun -= 1
        if p > end:
            raise UnsupportedJPEG("truncated JPEG")


# --------------------------------------------------------------------- pixels

CONST_BITS, PASS1_BITS = 13, 2
_FIX = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373, f1175=9633,
            f1501=12299, f1847=15137, f1961=16069, f2053=16819, f2562=20995, f3072=25172)


def _idct_1d(d, descale: int):
    """One pass of `jpeg_idct_islow` over 8 int64 arrays d[0..7] (the
    coefficients of one column or row, for many at once); d[0] and d[4] are
    scaled by 2^CONST_BITS, the outputs descaled."""
    f = _FIX
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * f["f0541"]
    tmp2 = z1 + z3 * -f["f1847"]
    tmp3 = z1 + z2 * f["f0765"]
    tmp0 = (d[0] + d[4]) << CONST_BITS
    tmp1 = (d[0] - d[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["f1175"]
    t0 = t0 * f["f0298"]
    t1 = t1 * f["f2053"]
    t2 = t2 * f["f3072"]
    t3 = t3 * f["f1501"]
    z1 = z1 * -f["f0899"]
    z2 = z2 * -f["f2562"]
    z3 = z3 * -f["f1961"] + z5
    z4 = z4 * -f["f0390"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    half = 1 << (descale - 1)
    return [(tmp10 + t3 + half) >> descale, (tmp11 + t2 + half) >> descale,
            (tmp12 + t1 + half) >> descale, (tmp13 + t0 + half) >> descale,
            (tmp13 - t0 + half) >> descale, (tmp12 - t1 + half) >> descale,
            (tmp11 - t2 + half) >> descale, (tmp10 - t3 + half) >> descale]


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """`jpeg_idct_islow` of [..., 64] coefficients in natural order with a
    quantisation table [64]: [..., 8, 8] uint8 samples."""
    x = coef.astype(np.int64) * quant.astype(np.int64)
    x = x.reshape(-1, 8, 8)
    # pass 1: columns (vectors along the vertical frequency)
    ws = np.stack(_idct_1d([x[:, k, :] for k in range(8)], CONST_BITS - PASS1_BITS), axis=1)
    # pass 2: rows, descaled by 8 more
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)], CONST_BITS + PASS1_BITS + 3), axis=2)
    # range_limit[x & RANGE_MASK] with the table centred on CENTERJSAMPLE
    out = np.clip(((out + 512) & 1023) - 512 + 128, 0, 255)
    return out.astype(np.uint8).reshape(coef.shape[:-1] + (8, 8))


def _fancy_h2(cs: np.ndarray, v2: bool) -> np.ndarray:
    """The horizontal half of `h2v1_fancy_upsample` (on samples: biases +1
    / +2, >> 2) or of `h2v2_fancy_upsample` (on column sums 3 near + far:
    biases +8 / +7, >> 4): [rows, w] -> [rows, 2w], edges by w."""
    out = np.empty((cs.shape[0], 2 * cs.shape[1]), np.int64)
    shift, even, odd = (4, 8, 7) if v2 else (2, 1, 2)
    out[:, 0] = (4 * cs[:, 0] + even) >> shift
    out[:, 1:-1:2] = (3 * cs[:, :-1] + cs[:, 1:] + odd) >> shift
    out[:, 2::2] = (3 * cs[:, 1:] + cs[:, :-1] + even) >> shift
    out[:, -1] = (4 * cs[:, -1] + odd) >> shift
    return out


def upsample(plane: np.ndarray, dw: int, dh: int, h2: bool, v2: bool,
             fancy: bool = True) -> np.ndarray:
    """A chroma plane ([>= dh, >= dw] uint8, its first dh x dw real) at twice
    its width (h2) and height (v2), as `jdsample.c` makes it."""
    p = plane[:dh, :dw].astype(np.int64)
    if not (fancy and dw > 2):
        if h2:
            p = np.repeat(p, 2, axis=1)
        if v2:
            p = np.repeat(p, 2, axis=0)
        return p.astype(np.uint8)
    if not v2:  # h2v1
        return _fancy_h2(p, False).astype(np.uint8)
    up = np.concatenate([p[:1], p[:-1]], axis=0)  # the row above, row 0 repeated
    down = np.concatenate([p[1:], p[-1:]], axis=0)  # the row below, the last repeated
    rows = np.empty((2 * dh, dw), np.int64)
    rows[0::2] = 3 * p + up
    rows[1::2] = 3 * p + down
    return _fancy_h2(rows, True).astype(np.uint8)


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda v: int(v * (1 << 16) + 0.5)  # noqa: E731
    half = 1 << 15
    return ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half)


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """`ycc_rgb_convert`: [H, W] uint8 planes -> [H, W, 3] uint8."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# ------------------------------------------------------------------- decoder

def _u16(data: bytes, i: int) -> int:
    return (data[i] << 8) | data[i + 1]


def decode(data: bytes) -> np.ndarray:
    """The pixels of a JPEG: [H, W] uint8 for one component, [H, W, 3] RGB
    for three (YCbCr converted, RGB as it is)."""
    data = bytes(data)
    if not data.startswith(SOI):
        raise ValueError("not a JPEG")
    pos = 2
    qt: Dict[int, np.ndarray] = {}
    dht: Dict[Tuple[int, int], bytes] = {}
    restart = 0
    frame = None
    jfif = False
    transform = None  # of an Adobe marker
    progressive = False
    coef: Optional[List[int]] = None
    quant: Dict[int, np.ndarray] = {}
    coef_bits = None
    saw_eoi = False
    while pos < len(data):
        if data[pos] != 0xFF:
            raise _corrupt(f"no marker at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:  # fill bytes
            pos += 1
        if pos >= len(data):
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            saw_eoi = True
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > len(data):
            break
        length = _u16(data, pos)
        seg = data[pos + 2:pos + length]
        if len(seg) < length - 2:
            raise UnsupportedJPEG("truncated JPEG")
        pos += length
        if marker == 0xE0 and seg[:5] == b"JFIF\x00" and length >= 16:
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and length >= 14:
            transform = seg[11]
        elif marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 64 * (2 if pq else 1)
                vals = np.frombuffer(seg[i + 1:i + 1 + n], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[NATURAL_ORDER] = vals.astype(np.int64)
                qt[tq] = table
                i += 1 + n
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                n = sum(seg[i + 1:i + 17])
                dht[(tc, th)] = seg[i + 1:i + 17 + n]
                i += 17 + n
        elif marker == 0xDD:
            restart = _u16(seg, 0)
        elif marker in _UNSUPPORTED_SOF:
            raise UnsupportedJPEG(_UNSUPPORTED_SOF[marker])
        elif marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise _corrupt("two frames")
            frame = _frame(seg)
            progressive = marker == 0xC2
            coef = [0] * (frame["total_blocks"] * 64 + 64)
            coef_bits = [[-1] * 64 for _ in frame["comps"]]
        elif marker == 0xDA:
            if frame is None:
                raise _corrupt("scan before frame")
            pos = _scan(data, pos, seg, frame, progressive, qt, dht, restart, coef, quant,
                        coef_bits)
        elif marker in (0xC8, 0xCC):
            raise UnsupportedJPEG("arithmetic-coded JPEG")
        elif marker == 0xDC:
            raise UnsupportedJPEG("JPEG with a DNL marker")
        # APPn, COM and the rest: skipped
    if frame is None or not saw_eoi:
        raise UnsupportedJPEG("truncated JPEG")
    if any(b != 0 for bits in coef_bits for b in bits):
        raise UnsupportedJPEG(
            "truncated JPEG" if not progressive else
            "progressive JPEG whose scans leave coefficient bits unsent (block smoothing)")
    return _pixels(frame, coef, quant, _color_space(frame, jfif, transform))


def _frame(seg: bytes) -> dict:
    precision, height, width, nf = seg[0], _u16(seg, 1), _u16(seg, 3), seg[5]
    if precision != 8:
        raise UnsupportedJPEG(f"{precision}-bit samples")
    if height == 0:
        raise UnsupportedJPEG("JPEG with a DNL marker")
    if nf == 4:
        raise UnsupportedJPEG("four-component JPEG (CMYK or YCCK)")
    if nf not in (1, 3):
        raise UnsupportedJPEG(f"{nf}-component JPEG")
    comps = []
    for i in range(nf):
        cid, hv, tq = seg[6 + 3 * i], seg[7 + 3 * i], seg[8 + 3 * i]
        comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
    if nf == 1:
        comps[0]["h"] = comps[0]["v"] = 1  # one component: one block an MCU
    else:
        luma = (comps[0]["h"], comps[0]["v"])
        if luma not in ((1, 1), (2, 1), (2, 2)) or any(
                (c["h"], c["v"]) != (1, 1) for c in comps[1:]):
            raise UnsupportedJPEG("chroma sampling other than 4:4:4, 4:2:2 or 4:2:0 ("
                                  + ", ".join(f"{c['h']}x{c['v']}" for c in comps) + ")")
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    offset = 0
    for c in comps:
        c["dw"] = -(-width * c["h"] // hmax)  # downsampled_width
        c["dh"] = -(-height * c["v"] // vmax)
        c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]  # blocks, MCU-padded
        c["wib"], c["hib"] = -(-c["dw"] // 8), -(-c["dh"] // 8)  # blocks, real
        c["offset"] = offset
        offset += c["bw"] * c["bh"]
    return dict(width=width, height=height, comps=comps, hmax=hmax, vmax=vmax, mcux=mcux,
                mcuy=mcuy, total_blocks=offset)


def _scan_blocks(frame, sel) -> Tuple[List[int], List[int], int]:
    """(base index of each block's coefficients, its component's place in
    the scan, blocks an MCU) in the scan's order."""
    comps = frame["comps"]
    if len(sel) == 1:
        c = comps[sel[0]]
        by, bx = np.mgrid[:c["hib"], :c["wib"]]
        idx = c["offset"] + by * c["bw"] + bx
        return (idx.reshape(-1) * 64).tolist(), [0] * idx.size, 1
    bases, which = [], []
    my, mx = np.mgrid[:frame["mcuy"], :frame["mcux"]]
    my, mx = my.reshape(-1, 1), mx.reshape(-1, 1)
    for j, ci in enumerate(sel):
        c = comps[ci]
        yy, xx = np.mgrid[:c["v"], :c["h"]]
        idx = c["offset"] + (my * c["v"] + yy.reshape(1, -1)) * c["bw"] + mx * c["h"] \
            + xx.reshape(1, -1)
        bases.append(idx)
        which.append(np.full(idx.shape, j))
    base = np.concatenate(bases, axis=1)
    return ((base.reshape(-1) * 64).tolist(), np.concatenate(which, axis=1).reshape(-1).tolist(),
            base.shape[1])


def _table(dht, kind: int, th: int, dc: bool):
    spec = dht.get((kind, th))
    if spec is None:
        raise _corrupt(f"Huffman table {th} is not defined")
    return _huffman(spec, dc)


def _scan(data, pos, seg, frame, progressive, qt, dht, restart, coef, quant, coef_bits):
    """Decode one scan into `coef` (zigzag order); the position after it."""
    ns = seg[0]
    ids = {c["id"]: i for i, c in enumerate(frame["comps"])}
    sel, tds, tas = [], [], []
    for i in range(ns):
        cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in ids:
            raise _corrupt(f"scan of an unknown component {cid}")
        sel.append(ids[cid])
        tds.append(t >> 4)
        tas.append(t & 15)
    ss, se, ah, al = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns] >> 4, \
        seg[3 + 2 * ns] & 15
    for ci in sel:  # libjpeg latches a component's table at its first scan
        if ci not in quant:
            tq = frame["comps"][ci]["tq"]
            if tq not in qt:
                raise _corrupt(f"quantisation table {tq} is not defined")
            quant[ci] = qt[tq]
    W, starts, ends, end = _segments(data, pos)
    blocks, which, per_mcu = _scan_blocks(frame, sel)
    spans = _intervals(len(blocks), per_mcu, restart, starts, ends)
    try:
        if not progressive:
            _sequential(W, spans, coef, blocks, which,
                        [_table(dht, 0, t, True) for t in tds],
                        [_table(dht, 1, t, False) for t in tas], ns)
            for ci in sel:
                coef_bits[ci] = [0] * 64
            return end
        bad = (ss == 0 and se != 0) or ss > se or se > 63 or (ss > 0 and ns != 1) \
            or al > 13 or (ah and al != ah - 1)
        for ci in sel:  # each refinement follows the scan that sent its bits
            bits = coef_bits[ci]
            bad = bad or any(ah != max(b, 0) for b in bits[ss:se + 1])
            bits[ss:se + 1] = [al] * (se + 1 - ss)
        if bad:
            raise _corrupt(f"bad progression Ss {ss} Se {se} Ah {ah} Al {al}")
        if ss == 0:
            if ah == 0:
                _dc_first(W, spans, coef, blocks, which,
                          [_table(dht, 0, t, True) for t in tds], ns, al)
            else:
                _dc_refine(W, spans, coef, blocks, al)
        else:
            tab = _table(dht, 1, tas[0], False)
            (_ac_refine if ah else _ac_first)(W, spans, coef, blocks, tab, ss, se, al)
    except IndexError:  # read past the scan's data
        raise UnsupportedJPEG("truncated JPEG") from None
    return end


def _color_space(frame, jfif: bool, transform) -> str:
    """`default_decompress_parms` for one or three components."""
    if len(frame["comps"]) == 1:
        return "L"
    if jfif:
        return "YCbCr"
    if transform is not None:
        return "RGB" if transform == 0 else "YCbCr"
    ids = tuple(c["id"] for c in frame["comps"])
    return "RGB" if ids == (82, 71, 66) else "YCbCr"


def _pixels(frame, coef, quant, space: str) -> np.ndarray:
    zz = np.asarray(coef[:frame["total_blocks"] * 64], np.int64).reshape(-1, 64)
    nat = np.empty_like(zz)
    nat[:, NATURAL_ORDER] = zz
    H, W = frame["height"], frame["width"]
    planes = []
    for ci, c in enumerate(frame["comps"]):
        blk = nat[c["offset"]:c["offset"] + c["bw"] * c["bh"]]
        px = idct_islow(blk, quant[ci]).reshape(c["bh"], c["bw"], 8, 8)
        px = px.transpose(0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8)
        h2, v2 = c["h"] < frame["hmax"], c["v"] < frame["vmax"]
        if h2 or v2:
            px = upsample(px, c["dw"], c["dh"], h2, v2)
        planes.append(px[:H, :W])
    if space == "L":
        return np.ascontiguousarray(planes[0])
    if space == "RGB":
        return np.ascontiguousarray(np.stack(planes, axis=-1))
    return ycc_to_rgb(*planes)


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def convert(px: np.ndarray, mode: str) -> np.ndarray:
    """Decoded pixels as Pillow's `convert(mode)` gives them: "RGB" repeats a
    grey channel, "L" of RGB is (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    if mode == "RGB":
        return np.repeat(px[..., None], 3, axis=2) if px.ndim == 2 else px
    if mode == "L":
        if px.ndim == 2:
            return px
        r, g, b = (px[..., i].astype(np.uint32) for i in range(3))
        return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)
    raise ValueError(f"mode {mode!r}: RGB or L")


def load(src: Union[str, bytes], mode: str = "RGB") -> np.ndarray:
    """`np.asarray(Image.open(src).convert(mode))` for mode "RGB" or "L" of
    a JPEG file (a path or its bytes) that this decoder takes."""
    return convert(decode(src) if isinstance(src, (bytes, bytearray)) else read(src), mode)
