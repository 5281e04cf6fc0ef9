"""Baseline JPEG in numpy: the port's stand-in for `cv2.imdecode` /
`cv2.imread` of a JPEG and for `cv2.imencode('.jpg')` / `cv2.imwrite`.

Both directions follow libjpeg-turbo's default integer path, the codec
that cv2 links, so a file decodes to cv2's pixels and an image encodes to
cv2's bytes:

- `decode_jpeg` reads baseline and extended sequential Huffman files
  (SOF0 / SOF1) of 8-bit samples with 1 or 3 components, sampling factors
  1 or 2 per axis (4:4:4, 4:2:2, 4:4:0, 4:2:0), interleaved or
  component-by-component scans and DRI restart intervals. A file without
  DHT uses the Annex K tables, as MJPEG frames in AVI expect. The pixels
  are the ISLOW inverse DCT of `jidctint.c` (13 fraction bits, 2 pass-1
  bits, the 1024-entry range-limit table), fancy upsampling from
  `jdsample.c` (the triangular filter with its biases at h2v1, h1v2 and
  h2v2, edges replicated; box replication where a downsampled row is 2
  samples or fewer) and the fixed-point YCbCr -> RGB tables of
  `jdcolor.c`. It returns BGR uint8, as cv2 does; greyscale is repeated
  into the three channels. Progressive, arithmetic-coded, lossless,
  hierarchical and 12-bit files raise `ValueError` naming the SOF marker.
- `encode_jpeg` writes what `cv2.imencode('.jpg', img, [IMWRITE_JPEG_QUALITY,
  q])` writes at cv2's other defaults: RGB -> YCbCr from `jccolor.c` (16
  fraction bits), chroma downsampled 2x2 with the alternating bias 1, 2
  (`jcsample.c`), the right column and bottom row repeated out to whole
  blocks, the ISLOW forward DCT of `jfdctint.c`,
  the reciprocal quantizer of `jcdctmgr.c`, the Annex K tables scaled by
  `jpeg_quality_scaling` and clamped to 8 bits, dummy blocks at the MCU
  edges with their left or upper neighbour's DC (`jccoefct.c`), and the
  standard Huffman tables. Markers come in `jcmarker.c`'s order: SOI, APP0
  JFIF 1.01, one DQT per table, SOF0, one DHT per table, SOS, the scan,
  EOI. The Huffman symbols and the bit packing are built on whole arrays,
  not per coefficient.

`decode_jpeg`'s Huffman walk is a Python loop over the symbols; the
inverse DCT, upsampling and colour conversion run on whole arrays.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# zigzag position -> natural (row-major) position; the 16 trailing 63s
# absorb a run that overshoots the block in a corrupt stream, as
# libjpeg's table does
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)
_NATURAL_PADDED = NATURAL_ORDER.tolist() + [63] * 16

# Annex K.1 quantization tables (luminance, chrominance), zigzag order
_STD_QUANT_HEX = (
    "100b0c0e0c0a100e0d0e1211101318281a181616183123251d283a333d3c3933383740485c4e404457453738506d51575f626768673e4d71797064785c656763",
    "1112121815182f1a1a2f634238426363636363636363636363636363636363636363636363636363636363636363636363636363636363636363636363636363",
)
# Annex K.3 Huffman tables as DHT bodies: class/id byte, 16 counts, values
_STD_HUFFMAN_HEX = (
    "0000010501010101010100000000000000000102030405060708090a0b",
    "100002010303020403050504040000017d01020300041105122131410613516107227114328191a1082342b1c11552d1f024"
    "33627282090a161718191a25262728292a3435363738393a434445464748494a535455565758595a636465666768696a7374"
    "75767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9ca"
    "d2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa",
    "0100030101010101010101010000000000000102030405060708090a0b",
    "1100020102040403040705040400010277000102031104052131061241510761711322328108144291a1b1c109233352f015"
    "6272d10a162434e125f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768696a73"
    "7475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8"
    "c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa",
)

# the SOF markers this decoder refuses, by what they announce
_REFUSED_SOF = {
    0xC2: "progressive DCT, Huffman", 0xC3: "lossless, Huffman",
    0xC5: "differential sequential DCT, Huffman", 0xC6: "differential progressive DCT, Huffman",
    0xC7: "differential lossless, Huffman", 0xC9: "extended sequential DCT, arithmetic",
    0xCA: "progressive DCT, arithmetic", 0xCB: "lossless, arithmetic",
    0xCD: "differential sequential DCT, arithmetic", 0xCE: "differential progressive DCT, arithmetic",
    0xCF: "differential lossless, arithmetic",
}

# jidctint.c / jfdctint.c fixed-point constants (CONST_BITS 13)
CONST_BITS = 13
PASS1_BITS = 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _range_limit_table() -> np.ndarray:
    """libjpeg's sample_range_limit (jdmaster.c::prepare_range_limit_table)
    as one array; the IDCT reads it at 384 + (x & 1023), the colour
    converter at 256 + x."""
    t = np.zeros(5 * 256 + 128, np.int64)
    t[256:512] = np.arange(256)
    t[512:896] = 255
    t[1280:1408] = np.arange(128)
    return t


_RANGE_LIMIT = _range_limit_table()


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


# ---------------------------------------------------------------------------
# tables


def _parse_dht_body(body: bytes, tables: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]]) -> None:
    """One DHT segment (it may hold several tables) into
    {(class, id): (counts (16,), values)}."""
    i = 0
    while i < len(body):
        tc, th = body[i] >> 4, body[i] & 15
        counts = np.frombuffer(body, np.uint8, 16, i + 1).astype(np.int64)
        n = int(counts.sum())
        values = np.frombuffer(body, np.uint8, n, i + 17).astype(np.int64)
        if tc > 1 or th > 3 or n > 256:
            raise ValueError("JPEG: bad DHT segment")
        tables[(tc, th)] = (counts, values)
        i += 17 + n


def _std_huffman() -> Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]]:
    tables: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
    for h in _STD_HUFFMAN_HEX:
        _parse_dht_body(bytes.fromhex(h), tables)
    return tables


STD_HUFFMAN = _std_huffman()
STD_QUANT = tuple(np.frombuffer(bytes.fromhex(h), np.uint8).astype(np.int64) for h in _STD_QUANT_HEX)


def _codes(counts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Annex C: the code and its length of each value, in table order."""
    lengths = np.repeat(np.arange(1, 17), counts)
    codes = np.zeros(len(lengths), np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(int(counts[length - 1])):
            codes[k] = code
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


def _lookup(counts: np.ndarray, values: np.ndarray) -> List[int]:
    """A 65536-entry decode table: a 16-bit lookahead -> (length << 8) |
    value, 0 where no code matches."""
    lut = np.zeros(1 << 16, np.int64)
    codes, lengths = _codes(counts)
    for code, length, value in zip(codes.tolist(), lengths.tolist(), values.tolist()):
        lo = code << (16 - length)
        lut[lo:lo + (1 << (16 - length))] = (length << 8) | value
    return lut.tolist()


# ---------------------------------------------------------------------------
# decoder


def _idct_1d(d, pass1: bool):
    """One pass of jidctint.c over 8 inputs (each an array); returns the 8
    outputs before the range limit."""
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 + z3 * (-_F1847)
    tmp3 = z1 + z2 * _F0765
    tmp0 = (d[0] + d[4]) << CONST_BITS
    tmp1 = (d[0] - d[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    tmp0, tmp1, tmp2, tmp3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * _F1175
    tmp0 = tmp0 * _F0298
    tmp1 = tmp1 * _F2053
    tmp2 = tmp2 * _F3072
    tmp3 = tmp3 * _F1501
    z1 = z1 * (-_F0899)
    z2 = z2 * (-_F2562)
    z3 = z3 * (-_F1961) + z5
    z4 = z4 * (-_F0390) + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4
    n = CONST_BITS - PASS1_BITS if pass1 else CONST_BITS + PASS1_BITS + 3
    return [_descale(v, n) for v in (tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
                                      tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3)]


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """(N, 64) dequantized coefficients in natural order -> (N, 8, 8)
    samples, libjpeg-turbo's jpeg_idct_islow."""
    x = coef.reshape(-1, 8, 8).astype(np.int64)
    ws = np.stack(_idct_1d([x[:, k, :] for k in range(8)], True), axis=1)  # columns
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)], False), axis=2)  # rows
    return _RANGE_LIMIT[384 + (out & 1023)].astype(np.uint8)


def _upsample(plane: np.ndarray, fh: int, fv: int, out_h: int, out_w: int) -> np.ndarray:
    """A downsampled component (its real samples only) -> full size, as
    jdsample.c's fancy upsamplers do it (edges replicated)."""
    p = plane.astype(np.int64)
    dh, dw = p.shape
    if fh == 2 and fv == 2 and dw > 2:
        ext = np.concatenate([p[:1], p, p[-1:]], axis=0)
        near = 3 * p
        up_sum = near + ext[:-2]  # rows 2i: the row above
        dn_sum = near + ext[2:]  # rows 2i+1: the row below
        out = np.empty((2 * dh, 2 * dw), np.int64)
        for rows, cs in ((slice(0, None, 2), up_sum), (slice(1, None, 2), dn_sum)):
            cext = np.concatenate([cs[:, :1], cs, cs[:, -1:]], axis=1)
            out[rows, 0::2] = (3 * cs + cext[:, :-2] + 8) >> 4
            out[rows, 1::2] = (3 * cs + cext[:, 2:] + 7) >> 4
    elif fh == 2 and fv == 1 and dw > 2:
        ext = np.concatenate([p[:, :1], p, p[:, -1:]], axis=1)
        out = np.empty((dh, 2 * dw), np.int64)
        out[:, 0::2] = (3 * p + ext[:, :-2] + 1) >> 2
        out[:, 1::2] = (3 * p + ext[:, 2:] + 2) >> 2
    elif fh == 1 and fv == 2:
        ext = np.concatenate([p[:1], p, p[-1:]], axis=0)
        out = np.empty((2 * dh, dw), np.int64)
        out[0::2] = (3 * p + ext[:-2] + 1) >> 2
        out[1::2] = (3 * p + ext[2:] + 2) >> 2
    else:  # box replication (h2v1 / h2v2 at 2 samples or fewer, and 1x1)
        out = np.repeat(np.repeat(p, fv, axis=0), fh, axis=1)
    return out[:out_h, :out_w]


def _ycc_to_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c::ycc_rgb_convert with its tables (16 fraction bits)."""
    one_half = 1 << 15
    x_cb, x_cr = cb - 128, cr - 128
    r = y + ((91881 * x_cr + one_half) >> 16)
    g = y + ((-22554 * x_cb + one_half - 46802 * x_cr) >> 16)
    b = y + ((116130 * x_cb + one_half) >> 16)
    return _RANGE_LIMIT[256 + np.stack([b, g, r], axis=-1)].astype(np.uint8)


def _scan_segments(data: bytes, pos: int) -> Tuple[List[np.ndarray], int]:
    """The entropy-coded data from `pos`: the segments between restart
    markers with the 0x00 stuffing removed, and the position of the marker
    that ends the scan."""
    arr = np.frombuffer(data, np.uint8, offset=pos)
    ff = np.flatnonzero(arr[:-1] == 0xFF)
    nxt = arr[ff + 1]
    rst = (nxt >= 0xD0) & (nxt <= 0xD7)
    ends = ff[(nxt != 0) & ~rst]
    end = int(ends[0]) if len(ends) else len(arr)
    cuts = ff[rst & (ff < end)]
    bounds = [0] + [int(c) for c in cuts] + [end]
    segments = []
    for k in range(len(bounds) - 1):
        lo = bounds[k] + (2 if k else 0)
        seg = arr[lo:bounds[k + 1]]
        stuffed = np.flatnonzero((seg[:-1] == 0xFF) & (seg[1:] == 0)) + 1
        segments.append(np.delete(seg, stuffed) if len(stuffed) else seg)
    return segments, pos + end


def _windows(seg: np.ndarray) -> List[int]:
    """The 64 bits that start at each byte of a segment (zeros past its
    end), as Python ints for the Huffman walk."""
    b = np.concatenate([seg, np.zeros(16, np.uint8)]).astype(np.uint64)
    n = len(seg) + 8
    w = np.zeros(n, np.uint64)
    for j in range(8):
        w |= b[j:j + n] << np.uint64(56 - 8 * j)
    return w.tolist()


def _decode_segment(words: List[int], comps: List[int], blocks: List[int], dc_luts, ac_luts,
                    n_comp: int, out_pos: List[int], out_val: List[int]) -> None:
    """Huffman-decode the blocks of one restart segment (jdhuff.c's
    decode_mcu for a sequential scan): block i belongs to scan component
    comps[i] and lands at blocks[i] * 64 in the coefficient buffer."""
    natural = _NATURAL_PADDED
    preds = [0] * n_comp
    p = 0
    for c, base in zip(comps, blocks):
        base *= 64
        t = (words[p >> 3] >> (32 - (p & 7))) & 0xFFFFFFFF
        e = dc_luts[c][t >> 16]
        if not e:
            raise ValueError("JPEG: corrupt entropy-coded data (bad DC code)")
        length, s = e >> 8, e & 0xFF
        if s:
            v = (t >> (32 - length - s)) & ((1 << s) - 1)
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
            preds[c] += v
        p += length + s
        out_pos.append(base)
        out_val.append(preds[c])
        ac = ac_luts[c]
        k = 1
        while k < 64:
            t = (words[p >> 3] >> (32 - (p & 7))) & 0xFFFFFFFF
            e = ac[t >> 16]
            length, rs = e >> 8, e & 0xFF
            s = rs & 15
            if s:
                k += rs >> 4
                v = (t >> (32 - length - s)) & ((1 << s) - 1)
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                out_pos.append(base + natural[k])
                out_val.append(v)
                p += length + s
                k += 1
            elif not e:
                raise ValueError("JPEG: corrupt entropy-coded data (bad AC code)")
            else:
                p += length
                if rs != 0xF0:
                    break  # EOB
                k += 16


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.qtable: Optional[np.ndarray] = None
        self.offset = 0  # first block in the coefficient buffer
        self.rows = self.cols = 0  # the MCU-padded block grid


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG file bytes -> (H, W, 3) BGR uint8, the pixels of cv2.imdecode
    (IMREAD_COLOR) through libjpeg-turbo's default path."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError("JPEG: no SOI marker")
    pos = 2
    qtables: Dict[int, np.ndarray] = {}
    huffman = dict(STD_HUFFMAN)
    restart = 0
    comps: List[_Component] = []
    height = width = 0
    coef: Optional[np.ndarray] = None
    saw_jfif, adobe_transform = False, None
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        length = int.from_bytes(data[pos:pos + 2], "big")
        body = data[pos + 2:pos + length]
        pos += length
        if marker in _REFUSED_SOF:
            raise ValueError(f"JPEG: SOF{marker - 0xC0} ({_REFUSED_SOF[marker]}) is not supported; "
                             "only baseline / extended sequential Huffman (SOF0, SOF1)")
        if marker in (0xC0, 0xC1):
            if body[0] != 8:
                raise ValueError(f"JPEG: SOF{marker - 0xC0} with {body[0]}-bit samples is not supported; "
                                 "only 8-bit")
            height, width, n = int.from_bytes(body[1:3], "big"), int.from_bytes(body[3:5], "big"), body[5]
            if n not in (1, 3):
                raise ValueError(f"JPEG: {n} components are not supported (1 or 3)")
            if height == 0 or width == 0:
                raise ValueError("JPEG: empty frame")
            comps = [_Component(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15, body[8 + 3 * i])
                     for i in range(n)]
            if any(c.h not in (1, 2) or c.v not in (1, 2) for c in comps):
                raise ValueError("JPEG: sampling factors other than 1 or 2 are not supported")
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            total = 0
            for c in comps:
                c.rows, c.cols, c.offset = mcuy * c.v, mcux * c.h, total
                total += c.rows * c.cols
            coef = np.zeros(total * 64, np.int64)
        elif marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    vals = np.frombuffer(body, ">u2", 64, i + 1).astype(np.int64)
                else:
                    vals = np.frombuffer(body, np.uint8, 64, i + 1).astype(np.int64)
                table = np.zeros(64, np.int64)
                table[NATURAL_ORDER] = vals
                qtables[tq] = table
                i += 1 + 64 * (2 if pq else 1)
        elif marker == 0xC4:
            _parse_dht_body(body, huffman)
        elif marker == 0xDD:
            restart = int.from_bytes(body[0:2], "big")
        elif marker == 0xCC:
            raise ValueError("JPEG: DAC (arithmetic coding) is not supported")
        elif marker == 0xE0 and body[:5] == b"JFIF\0":
            saw_jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_transform = body[11]
        elif marker == 0xDA:
            if coef is None:
                raise ValueError("JPEG: SOS before SOF")
            pos = _decode_scan(data, pos, body, comps, width, height, qtables, huffman, restart, coef)
    if coef is None:
        raise ValueError("JPEG: no frame")
    return _reconstruct(comps, coef, width, height, saw_jfif, adobe_transform)


def _decode_scan(data, pos, header, comps, width, height, qtables, huffman, restart, coef) -> int:
    ns = header[0]
    by_id = {c.cid: c for c in comps}
    scomps, dc_luts, ac_luts = [], [], []
    for i in range(ns):
        c = by_id.get(header[1 + 2 * i])
        if c is None:
            raise ValueError("JPEG: SOS names an unknown component")
        td, ta = header[2 + 2 * i] >> 4, header[2 + 2 * i] & 15
        if (0, td) not in huffman or (1, ta) not in huffman:
            raise ValueError("JPEG: SOS names a Huffman table that is not defined")
        if c.qtable is None:  # latched at the component's first scan, as libjpeg does
            if c.tq not in qtables:
                raise ValueError(f"JPEG: quantization table {c.tq} is not defined")
            c.qtable = qtables[c.tq].copy()
        scomps.append(c)
        dc_luts.append(_lookup(*huffman[(0, td)]))
        ac_luts.append(_lookup(*huffman[(1, ta)]))
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    if ns == 1:  # one block per MCU over the component's own blocks
        c = scomps[0]
        bw = -(-(-(-width * c.h // hmax)) // 8)
        bh = -(-(-(-height * c.v // vmax)) // 8)
        rr, cc = np.meshgrid(np.arange(bh), np.arange(bw), indexing="ij")
        blocks = (c.offset + rr * c.cols + cc).reshape(-1, 1)
        owners = np.zeros_like(blocks)
    else:
        mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
        my, mx = np.meshgrid(np.arange(mcuy), np.arange(mcux), indexing="ij")
        my, mx = my.reshape(-1, 1), mx.reshape(-1, 1)
        parts, owner_parts = [], []
        for s, c in enumerate(scomps):
            for by in range(c.v):
                for bx in range(c.h):
                    parts.append(c.offset + (my * c.v + by) * c.cols + mx * c.h + bx)
                    owner_parts.append(np.full_like(my, s))
        blocks, owners = np.concatenate(parts, axis=1), np.concatenate(owner_parts, axis=1)
    n_mcu, per_mcu = blocks.shape
    segments, end = _scan_segments(data, pos)
    interval = restart if restart else n_mcu
    out_pos: List[int] = []
    out_val: List[int] = []
    for k, seg in enumerate(segments):
        lo, hi = k * interval, min((k + 1) * interval, n_mcu)
        if lo >= n_mcu:
            break
        _decode_segment(_windows(seg), owners[lo:hi].reshape(-1).tolist(), blocks[lo:hi].reshape(-1).tolist(),
                        dc_luts, ac_luts, ns, out_pos, out_val)
    coef[np.asarray(out_pos, np.int64)] = np.asarray(out_val, np.int64)
    return end


def _reconstruct(comps, coef, width, height, saw_jfif, adobe_transform) -> np.ndarray:
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    planes = []
    for c in comps:
        if c.qtable is None:
            planes.append(np.zeros((height, width), np.int64))
            continue
        n = c.rows * c.cols
        blocks = coef[c.offset * 64:(c.offset + n) * 64].reshape(n, 64) * c.qtable
        px = idct_islow(blocks).reshape(c.rows, c.cols, 8, 8).transpose(0, 2, 1, 3).reshape(c.rows * 8, c.cols * 8)
        dh, dw = -(-height * c.v // vmax), -(-width * c.h // hmax)
        planes.append(_upsample(px[:dh, :dw], hmax // c.h, vmax // c.v, height, width))
    if len(planes) == 1:
        g = planes[0].astype(np.uint8)
        return np.repeat(g[:, :, None], 3, axis=2)
    ids = [c.cid for c in comps]
    rgb = (not saw_jfif) and (adobe_transform == 0 if adobe_transform is not None else ids == [82, 71, 66])
    if rgb:
        return np.stack([planes[2], planes[1], planes[0]], axis=-1).astype(np.uint8)
    return _ycc_to_bgr(*planes)


# ---------------------------------------------------------------------------
# encoder


def quality_scaling(quality: int) -> int:
    """jcparam.c::jpeg_quality_scaling."""
    quality = min(max(int(quality), 1), 100)
    return 5000 // quality if quality < 50 else 200 - 2 * quality


def quant_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """The luminance and chrominance tables (natural order) at `quality`,
    force_baseline as cv2 asks: each (base * scale + 50) / 100 in 1..255."""
    scale = quality_scaling(quality)
    out = []
    for zz in STD_QUANT:
        t = np.clip((zz * scale + 50) // 100, 1, 255)
        natural = np.zeros(64, np.int64)
        natural[NATURAL_ORDER] = t
        out.append(natural)
    return out[0], out[1]


def _bgr_to_ycc(bgr: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """jccolor.c::rgb_ycc_convert with its tables (16 fraction bits)."""
    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    one_half = 1 << 15
    cbcr_offset = 128 << 16
    y = (19595 * r + 38470 * g + 7471 * b + one_half) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + cbcr_offset + one_half - 1) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + cbcr_offset + one_half - 1) >> 16
    return y, cb, cr


def _pad_edges(p: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Repeat the last row and column out to (rows, cols), as
    jcsample.c::expand_right_edge and jcprepct.c::expand_bottom_edge do."""
    return np.pad(p, ((0, max(rows - p.shape[0], 0)), (0, max(cols - p.shape[1], 0))), mode="edge")[:rows, :cols]


def _downsample_h2v2(p: np.ndarray) -> np.ndarray:
    """jcsample.c::h2v2_downsample: each 2 x 2 block averaged with the bias
    1, 2, 1, 2, ... along the row."""
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    return (s + np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)) >> 2


def _fdct_1d(d, pass1: bool):
    """One pass of jfdctint.c::jpeg_fdct_islow over 8 inputs."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if pass1:
        out[0] = (tmp10 + tmp11) << PASS1_BITS
        out[4] = (tmp10 - tmp11) << PASS1_BITS
        n = CONST_BITS - PASS1_BITS
    else:
        out[0] = _descale(tmp10 + tmp11, PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, PASS1_BITS)
        n = CONST_BITS + PASS1_BITS
    z1 = (tmp12 + tmp13) * _F0541
    out[2] = _descale(z1 + tmp13 * _F0765, n)
    out[6] = _descale(z1 + tmp12 * (-_F1847), n)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4 = tmp4 * _F0298
    tmp5 = tmp5 * _F2053
    tmp6 = tmp6 * _F3072
    tmp7 = tmp7 * _F1501
    z1 = z1 * (-_F0899)
    z2 = z2 * (-_F2562)
    z3 = z3 * (-_F1961) + z5
    z4 = z4 * (-_F0390) + z5
    out[7] = _descale(tmp4 + z1 + z3, n)
    out[5] = _descale(tmp5 + z2 + z4, n)
    out[3] = _descale(tmp6 + z2 + z3, n)
    out[1] = _descale(tmp7 + z1 + z4, n)
    return out


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """(N, 8, 8) samples -> (N, 64) DCT coefficients scaled by 8, natural
    order (jpeg_fdct_islow on samples - 128)."""
    x = blocks.astype(np.int64) - 128
    rows = np.stack(_fdct_1d([x[:, :, k] for k in range(8)], True), axis=2)
    cols = np.stack(_fdct_1d([rows[:, k, :] for k in range(8)], False), axis=1)
    return cols.reshape(-1, 64)


def _quantize(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """jcdctmgr.c's reciprocal quantizer (compute_reciprocal + quantize)
    with 16-bit DCTELEMs: sign(x) * (((|x| + c) * recip) >> r) with the
    divisor 8 * q."""
    div = (qtable * 8).astype(np.int64)
    recip = np.empty(64, np.int64)
    corr = np.empty(64, np.int64)
    shift = np.empty(64, np.int64)
    for i, d in enumerate(div.tolist()):
        if d == 1:
            recip[i], corr[i], shift[i] = 1, 0, 0
            continue
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip[i], corr[i], shift[i] = fq, c, r
    mag = ((np.abs(coef) + corr) * recip) >> shift
    return np.where(coef < 0, -mag, mag)


def _bit_length(a: np.ndarray) -> np.ndarray:
    return np.frexp(a.astype(np.float64))[1].astype(np.int64)


def _code_table(counts: np.ndarray, values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Huffman value -> (code, length), 0 length for an absent value."""
    codes, lengths = _codes(counts)
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    code[values], size[values] = codes, lengths
    return code, size


def _segment(kind: int, body: bytes) -> bytes:
    return bytes([0xFF, kind]) + (len(body) + 2).to_bytes(2, "big") + body


def _entropy_code(zz: np.ndarray, owner: np.ndarray, tables) -> bytes:
    """Huffman-code the quantized blocks (zigzag order, scan order; block i
    of component owner[i]) into the scan's bytes: 0x00 stuffed after each
    0xFF, the last byte padded with 1 bits (jchuff.c)."""
    nb = len(zz)
    dc = zz[:, 0]
    prev = np.zeros(nb, np.int64)
    for c in np.unique(owner):
        idx = np.flatnonzero(owner == c)
        prev[idx[1:]] = dc[idx[:-1]]
    diff = dc - prev
    dsize = _bit_length(np.abs(diff))
    dextra = np.where(diff < 0, diff - 1, diff) & ((1 << dsize) - 1)
    dc_code = np.stack([t[0][0] for t in tables])[owner, dsize]
    dc_len = np.stack([t[0][1] for t in tables])[owner, dsize]
    # events (code and extra bits as one value, its length), each with a
    # sort key block * 256 + slot: DC 0, the ZRLs before the coefficient at
    # zigzag k 2k - 1, that coefficient 2k, EOB 128
    values = [(dc_code << dsize) | dextra]
    lengths = [dc_len + dsize]
    keys = [np.arange(nb, dtype=np.int64) * 256]

    blk, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[blk, k]
    prev_k = np.zeros_like(k)
    prev_k[1:] = np.where(blk[1:] == blk[:-1], k[:-1], 0)
    run = k - prev_k - 1
    asize = _bit_length(np.abs(v))
    aextra = np.where(v < 0, v - 1, v) & ((1 << asize) - 1)
    ac_codes = np.stack([t[1][0] for t in tables])
    ac_lens = np.stack([t[1][1] for t in tables])
    o = owner[blk]
    sym = ((run & 15) << 4) | asize
    values.append((ac_codes[o, sym] << asize) | aextra)
    lengths.append(ac_lens[o, sym] + asize)
    keys.append(blk * 256 + 2 * k)
    rep = np.repeat(np.arange(len(k)), run >> 4)  # a ZRL per 16 zeros
    values.append(ac_codes[o[rep], 0xF0])
    lengths.append(ac_lens[o[rep], 0xF0])
    keys.append(blk[rep] * 256 + 2 * k[rep] - 1)
    last = np.zeros(nb, np.int64)
    last[blk] = k  # the last nonzero's position wins (blk is sorted)
    eob = np.flatnonzero(last < 63)
    values.append(ac_codes[owner[eob], 0x00])
    lengths.append(ac_lens[owner[eob], 0x00])
    keys.append(eob * 256 + 128)

    order = np.argsort(np.concatenate(keys), kind="stable")
    value = np.concatenate(values)[order]
    length = np.concatenate(lengths)[order]
    start = np.cumsum(length) - length
    total = int(length.sum())
    ev = np.repeat(np.arange(len(length)), length)
    within = np.arange(total, dtype=np.int64) - start[ev]
    bits = np.ones(-(-total // 8) * 8, np.uint8)  # the padding stays 1 bits
    bits[:total] = (value[ev] >> (length[ev] - 1 - within)) & 1
    raw = np.packbits(bits)
    return np.insert(raw, np.flatnonzero(raw == 0xFF) + 1, 0).tobytes()


def encode_jpeg(image: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) BGR uint8 -> JPEG file bytes, those of
    cv2.imencode('.jpg', image, [IMWRITE_JPEG_QUALITY, quality]) at cv2's
    other defaults (4:2:0, no restart markers, standard Huffman tables)."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image; got {image.dtype} {image.shape}")
    height, width = image.shape[:2]
    if not (0 < height < 65536 and 0 < width < 65536):
        raise ValueError(f"JPEG: size {width} x {height} out of range")
    tables = quant_tables(quality)
    # (id, h, v, table): Y at 2 x 2, Cb and Cr at 1 x 1 (jcparam.c)
    spec = ((1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1))
    mcux, mcuy = -(-width // 16), -(-height // 16)
    my, mx = (a.reshape(-1) for a in np.meshgrid(np.arange(mcuy), np.arange(mcux), indexing="ij"))
    per_mcu, owners = [], []
    for c, ((_, h, v, tq), plane) in enumerate(zip(spec, _bgr_to_ycc(image))):
        wib, hib = -(-width * h // 16), -(-height * v // 16)  # the component's blocks
        # repeat the right column and bottom row (jcsample.c::expand_right_edge,
        # jcprepct.c::expand_bottom_edge): chroma to even rows and to its
        # blocks' full width before the downsample, then to whole blocks
        if h == 1:
            plane = _downsample_h2v2(_pad_edges(plane, -(-height // 2) * 2, wib * 16))
        down = _pad_edges(plane, hib * 8, wib * 8)
        blocks = down.reshape(hib, 8, wib, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
        q = _quantize(fdct_islow(blocks), tables[tq]).reshape(hib, wib, 64)
        # the MCU grid's dummy blocks: zero AC, the DC of the block to the
        # left (right edge) or of the MCU's last block a row up (bottom)
        g = np.zeros((mcuy * v, mcux * h, 64), np.int64)
        g[:hib, :wib] = q
        g[:hib, wib:, 0] = q[:, wib - 1:wib, 0]
        for r in range(hib, mcuy * v):
            g[r, :, 0] = np.repeat(g[r - 1, h - 1::h, 0], h)
        for by in range(v):
            for bx in range(h):
                per_mcu.append(g[my * v + by, mx * h + bx])
                owners.append(c)
    blocks = np.stack(per_mcu, axis=1).reshape(-1, 64)
    owner = np.tile(np.asarray(owners, np.int64), len(my))
    huffman = [(_code_table(*STD_HUFFMAN[(0, t)]), _code_table(*STD_HUFFMAN[(1, t)])) for t in (0, 1, 1)]
    scan = _entropy_code(blocks[:, NATURAL_ORDER], owner, huffman)

    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, table in enumerate(tables):
        out.append(_segment(0xDB, bytes([t]) + table[NATURAL_ORDER].astype(np.uint8).tobytes()))
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") + bytes([len(spec)])
    out.append(_segment(0xC0, sof + b"".join(bytes([cid, (h << 4) | v, tq]) for cid, h, v, tq in spec)))
    for t in (0, 1):
        for cls in (0, 1):
            counts, values = STD_HUFFMAN[(cls, t)]
            out.append(_segment(0xC4, bytes([(cls << 4) | t]) + counts.astype(np.uint8).tobytes()
                                + values.astype(np.uint8).tobytes()))
    sos = bytes([len(spec)]) + b"".join(bytes([cid, 0x11 * tq]) for cid, _, _, tq in spec)
    out += [_segment(0xDA, sos + b"\x00\x3f\x00"), scan, b"\xff\xd9"]
    return b"".join(out)
