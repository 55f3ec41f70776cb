# JPEG decoder in numpy: baseline and progressive, Huffman-coded, 8-bit.
#
# Reads what PIL reads on the JAX side of the port (PIL.Image.open on a
# JPEG decodes through libjpeg's defaults), and the way it does, so that the
# two readers give the same pixels:
#   * Huffman decoding of sequential (SOF0/SOF1) and progressive (SOF2)
#     scans, the four progressive scan kinds (DC first and refinement, AC
#     first and refinement, with end-of-band runs), restart intervals
#     (ITU-T T.81, Annexes F and G);
#   * dequantisation and libjpeg's integer "islow" inverse DCT (jidctint.c:
#     13-bit constants, two passes, the range-limit table of jdmaster.c);
#   * libjpeg's "fancy" (triangular) chroma upsampling for h2v1, h1v2 and
#     h2v2 (jdsample.c), the image's first and last rows and columns
#     repeated at the edges, and replication for other integer ratios;
#   * libjpeg's fixed-point YCbCr -> RGB (jdcolor.c, 16 fraction bits).
# A 3-component image is YCbCr unless an Adobe APP14 marker says transform 0
# or its component ids spell 'RGB', as libjpeg guesses.  Grey images come
# back [H,W], colour [H,W,3] uint8.  Arithmetic coding, lossless, 12-bit
# and CMYK JPEGs raise ValueError, as does malformed input.  The entropy
# decoder is a Python loop (about 2 us a coefficient); the transforms are
# vectorised over all blocks.

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np

# zig-zag position -> natural (row-major) index, with 16 spare entries that
# absorb a run past the last coefficient, as libjpeg's table does
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
    + [63] * 16)
_NAT = NATURAL_ORDER.tolist()

# jidctint.c constants, CONST_BITS 13
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _range_limit() -> np.ndarray:
    """The IDCT's output table of jdmaster.c, indexed by (x & 1023): x+128
    clamped to [0,255] for x in [-512, 511], wrapping beyond."""
    x = np.arange(1024)
    x = np.where(x >= 512, x - 1024, x)
    return np.clip(x + 128, 0, 255).astype(np.uint8)


RANGE_LIMIT = _range_limit()


class _Huffman:
    """A Huffman table as a 16-bit lookup: code prefix -> (length, symbol)."""

    def __init__(self, counts, symbols):
        lengths = [0] * 65536
        values = [0] * 65536
        code, k = 0, 0
        for n_bits in range(1, 17):
            for _ in range(counts[n_bits - 1]):
                if code >= (1 << n_bits):
                    raise ValueError('JPEG: bad Huffman table')
                lo = code << (16 - n_bits)
                hi = (code + 1) << (16 - n_bits)
                lengths[lo:hi] = [n_bits] * (hi - lo)
                values[lo:hi] = [symbols[k]] * (hi - lo)
                code += 1
                k += 1
            code <<= 1
        self.lengths = lengths
        self.values = values


class _Bits:
    """MSB-first bit reader over one entropy-coded segment with its byte
    stuffing removed; reads past the end give zero bits, as libjpeg's."""

    def __init__(self, data: bytes):
        self.d = data.replace(b'\xff\x00', b'\xff') + bytes(8)
        self.pos = 0

    def decode(self, table: _Huffman) -> int:
        p = self.pos
        i = p >> 3
        d = self.d
        v = ((d[i] << 16 | d[i + 1] << 8 | d[i + 2]) >> (8 - (p & 7))) \
            & 0xffff
        n = table.lengths[v]
        if n == 0:
            raise ValueError('JPEG: bad Huffman code')
        self.pos = p + n
        return table.values[v]

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        i = p >> 3
        d = self.d
        v = (d[i] << 24 | d[i + 1] << 16 | d[i + 2] << 8 | d[i + 3])
        self.pos = p + n
        return (v >> (32 - (p & 7) - n)) & ((1 << n) - 1)

    def extend(self, s: int) -> int:
        """A magnitude category s and its s raw bits -> the signed value."""
        v = self.bits(s)
        return v if v >= (1 << (s - 1)) else v - (1 << s) + 1


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None                     # latched at its first scan
        self.coefs = None                     # [rows, cols, 64] natural
        self.pred = 0


def _segments(data: bytes, pos: int):
    """Split the entropy-coded data from `pos` at restart markers ->
    (list of segments, position of the marker that ends the scan)."""
    segs, start = [], pos
    while True:
        i = data.find(b'\xff', pos)
        if i < 0 or i + 1 >= len(data):
            raise ValueError('JPEG: scan without an end')
        nxt = data[i + 1]
        if nxt == 0x00 or nxt == 0xff:
            pos = i + 1 if nxt == 0xff else i + 2
            continue
        if 0xd0 <= nxt <= 0xd7:
            segs.append(data[start:i])
            start = pos = i + 2
            continue
        segs.append(data[start:i])
        return segs, i


class _Decoder:
    def __init__(self, data: bytes, name: str):
        self.data = data
        self.name = name
        self.quant: Dict[int, np.ndarray] = {}
        self.dc: Dict[int, _Huffman] = {}
        self.ac: Dict[int, _Huffman] = {}
        self.restart = 0
        self.comps: List[_Component] = []
        self.progressive = False
        self.adobe_transform = None
        self.eobrun = 0

    def fail(self, msg: str):
        raise ValueError(f'{self.name}: {msg}')

    # ------------------------------------------------------------ markers
    def run(self) -> np.ndarray:
        data = self.data
        pos = 2
        frame = False
        while pos < len(data):
            if data[pos] != 0xff:
                self.fail(f'JPEG: no marker at byte {pos}')
            marker = data[pos + 1]
            pos += 2
            if marker == 0xff:            # fill byte
                pos -= 1
                continue
            if marker == 0xd9:            # EOI
                break
            if 0xd0 <= marker <= 0xd7 or marker == 0x01:
                continue
            if pos + 2 > len(data):
                self.fail('JPEG: truncated marker')
            n = struct.unpack('>H', data[pos:pos + 2])[0]
            body = data[pos + 2:pos + n]
            if len(body) != n - 2:
                self.fail('JPEG: truncated marker segment')
            pos += n
            if marker == 0xdb:
                self.read_dqt(body)
            elif marker == 0xc4:
                self.read_dht(body)
            elif marker == 0xdd:
                self.restart = struct.unpack('>H', body[:2])[0]
            elif marker in (0xc0, 0xc1, 0xc2):
                self.read_sof(body, marker == 0xc2)
                frame = True
            elif 0xc3 <= marker <= 0xcf and marker not in (0xc4, 0xc8,
                                                           0xcc):
                self.fail(f'JPEG: unsupported frame type 0x{marker:02x} '
                          '(lossless, hierarchical or arithmetic-coded)')
            elif marker == 0xee and body[:5] == b'Adobe' and len(body) >= 12:
                self.adobe_transform = body[11]
            elif marker == 0xda:
                if not frame:
                    self.fail('JPEG: scan before the frame header')
                pos = self.read_scan(body, pos)
        if not frame:
            self.fail('JPEG: no frame header')
        return self.output()

    def read_dqt(self, body: bytes):
        i = 0
        while i < len(body):
            pq, tq = body[i] >> 4, body[i] & 15
            size = 128 if pq else 64
            raw = body[i + 1:i + 1 + size]
            if len(raw) != size:
                self.fail('JPEG: truncated quantisation table')
            zz = np.frombuffer(raw, '>u2' if pq else np.uint8).astype(
                np.int64)
            table = np.zeros(64, np.int64)
            table[NATURAL_ORDER[:64]] = zz
            self.quant[tq] = table
            i += 1 + size

    def read_dht(self, body: bytes):
        i = 0
        while i < len(body):
            tc, th = body[i] >> 4, body[i] & 15
            counts = list(body[i + 1:i + 17])
            total = sum(counts)
            symbols = list(body[i + 17:i + 17 + total])
            if len(counts) != 16 or len(symbols) != total:
                self.fail('JPEG: truncated Huffman table')
            (self.ac if tc else self.dc)[th] = _Huffman(counts, symbols)
            i += 17 + total

    def read_sof(self, body: bytes, progressive: bool):
        precision, height, width, nc = struct.unpack('>BHHB', body[:6])
        if precision != 8:
            self.fail(f'JPEG: {precision}-bit samples are not supported')
        if nc not in (1, 3):
            self.fail(f'JPEG: {nc} components are not supported')
        if height == 0 or width == 0:
            self.fail('JPEG: empty image or height set by DNL')
        self.height, self.width = height, width
        self.progressive = progressive
        for k in range(nc):
            cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4):
                self.fail('JPEG: bad sampling factors')
            self.comps.append(_Component(cid, h, v, tq))
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcux = -(-width // (8 * self.hmax))
        self.mcuy = -(-height // (8 * self.vmax))
        for c in self.comps:
            c.width = -(-width * c.h // self.hmax)       # downsampled size
            c.height = -(-height * c.v // self.vmax)
            c.bx = -(-c.width // 8)                      # blocks it codes
            c.by = -(-c.height // 8)
            c.coefs = np.zeros((self.mcuy * c.v, self.mcux * c.h, 64),
                               np.int64)

    # --------------------------------------------------------------- scans
    def read_scan(self, body: bytes, pos: int) -> int:
        ns = body[0]
        by_id = {c.id: c for c in self.comps}
        comps, tables = [], []
        for k in range(ns):
            cid, t = body[1 + 2 * k:3 + 2 * k]
            if cid not in by_id:
                self.fail(f'JPEG: scan names unknown component {cid}')
            comps.append(by_id[cid])
            tables.append((t >> 4, t & 15))
        ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
        ah, al = a >> 4, a & 15
        if not self.progressive:
            ss, se, ah, al = 0, 63, 0, 0
        for c in comps:
            if c.quant is None:
                if c.tq not in self.quant:
                    self.fail(f'JPEG: no quantisation table {c.tq}')
                c.quant = self.quant[c.tq].copy()
        try:
            dcs = [self.dc[td] if ss == 0 and ah == 0 else None
                   for td, _ in tables]
            acs = [self.ac[ta] if se > 0 else None for _, ta in tables]
        except KeyError as e:
            self.fail(f'JPEG: scan uses undefined Huffman table {e}')
        segs, end = _segments(self.data, pos)
        # the (component, block row, block column) of every block in order
        if ns == 1:
            c = comps[0]
            units = [[(0, r, q)] for r in range(c.by) for q in range(c.bx)]
        else:
            units = [[(k, my * c.v + y, mx * c.h + x)
                      for k, c in enumerate(comps)
                      for y in range(c.v) for x in range(c.h)]
                     for my in range(self.mcuy) for mx in range(self.mcux)]
        per_seg = self.restart or len(units)
        for s in range(0, len(units), per_seg):
            seg = segs[s // per_seg] if s // per_seg < len(segs) else b''
            bits = _Bits(seg)
            for c in comps:
                c.pred = 0
            self.eobrun = 0
            for unit in units[s:s + per_seg]:
                for k, r, q in unit:
                    c = comps[k]
                    block = c.coefs[r, q]
                    if ss == 0:
                        if ah == 0:
                            t = bits.decode(dcs[k])
                            c.pred += bits.extend(t) if t else 0
                            block[0] = c.pred << al
                        elif bits.bits(1):
                            block[0] |= 1 << al
                        if not self.progressive:
                            self.ac_sequential(bits, acs[k], block)
                    elif ah == 0:
                        self.ac_first(bits, acs[k], block, ss, se, al)
                    else:
                        self.ac_refine(bits, acs[k], block, ss, se, al)
        return end

    @staticmethod
    def ac_sequential(bits: _Bits, table: _Huffman, block) -> None:
        k = 1
        while k < 64:
            rs = bits.decode(table)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                block[_NAT[k]] = bits.extend(s)
                k += 1
            elif r == 15:
                k += 16
            else:
                break

    def ac_first(self, bits: _Bits, table: _Huffman, block, ss: int,
                 se: int, al: int) -> None:
        if self.eobrun > 0:
            self.eobrun -= 1
            return
        k = ss
        while k <= se:
            rs = bits.decode(table)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                block[_NAT[k]] = bits.extend(s) * (1 << al)
            elif r == 15:
                k += 15
            else:
                self.eobrun = (1 << r) + bits.bits(r) - 1
                break
            k += 1

    def ac_refine(self, bits: _Bits, table: _Huffman, block, ss: int,
                  se: int, al: int) -> None:
        p1, m1 = 1 << al, -1 << al
        k = ss
        if self.eobrun == 0:
            while k <= se:
                rs = bits.decode(table)
                r, s = rs >> 4, rs & 15
                if s:
                    s = p1 if bits.bits(1) else m1
                elif r != 15:
                    self.eobrun = (1 << r) + bits.bits(r)
                    break
                # pass over nonzero coefficients (refining each) and r
                # zero ones
                while k <= se:
                    pos = _NAT[k]
                    coef = block[pos]
                    if coef != 0:
                        if bits.bits(1) and (coef & p1) == 0:
                            block[pos] = coef + (p1 if coef >= 0 else m1)
                    else:
                        if r == 0:
                            break
                        r -= 1
                    k += 1
                if s:
                    block[_NAT[k]] = s
                k += 1
        if self.eobrun > 0:
            while k <= se:
                pos = _NAT[k]
                coef = block[pos]
                if coef != 0 and bits.bits(1) and (coef & p1) == 0:
                    block[pos] = coef + (p1 if coef >= 0 else m1)
                k += 1
            self.eobrun -= 1

    # -------------------------------------------------------------- output
    def plane(self, c: _Component) -> np.ndarray:
        """Dequantise + islow IDCT of every block -> the component's
        [height, width] samples (its downsampled size)."""
        rows, cols = c.coefs.shape[:2]
        blocks = idct_islow(c.coefs.reshape(-1, 64) * c.quant)
        img = blocks.reshape(rows, cols, 8, 8).transpose(0, 2, 1, 3)
        return img.reshape(rows * 8, cols * 8)[:c.height, :c.width]

    def output(self) -> np.ndarray:
        planes = []
        for c in self.comps:
            p = self.plane(c)
            fh, fv = self.hmax // c.h, self.vmax // c.v
            if fh * c.h != self.hmax or fv * c.v != self.vmax:
                self.fail('JPEG: non-integral sampling ratio')
            planes.append(upsample(p, fh, fv)[:self.height, :self.width])
        if len(planes) == 1:
            return planes[0]
        ids = bytes(c.id for c in self.comps)
        if self.adobe_transform == 0 or ids == b'RGB':
            return np.stack(planes, axis=-1)
        return ycc_to_rgb(*planes)


def idct_islow(coefs: np.ndarray) -> np.ndarray:
    """libjpeg's jpeg_idct_islow over [N, 64] dequantised coefficients
    (natural order) -> [N, 64] uint8 samples."""
    x = coefs.astype(np.int64).reshape(-1, 8, 8)

    def one_pass(v, shift_even, shift_out):
        # v[..., k] are the 8 inputs of each 1-D transform along the last axis
        z2, z3 = v[..., 2], v[..., 6]
        z1 = (z2 + z3) * FIX_0_541196100
        tmp2 = z1 + z3 * -FIX_1_847759065
        tmp3 = z1 + z2 * FIX_0_765366865
        tmp0 = (v[..., 0] + v[..., 4]) << shift_even
        tmp1 = (v[..., 0] - v[..., 4]) << shift_even
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        t0, t1, t2, t3 = v[..., 7], v[..., 5], v[..., 3], v[..., 1]
        z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
        z5 = (z3 + z4) * FIX_1_175875602
        t0 = t0 * FIX_0_298631336
        t1 = t1 * FIX_2_053119869
        t2 = t2 * FIX_3_072711026
        t3 = t3 * FIX_1_501321110
        z1 = z1 * -FIX_0_899976223
        z2 = z2 * -FIX_2_562915447
        z3 = z3 * -FIX_1_961570560 + z5
        z4 = z4 * -FIX_0_390180644 + z5
        t0 += z1 + z3
        t1 += z2 + z4
        t2 += z2 + z3
        t3 += z1 + z4
        rnd = 1 << (shift_out - 1)
        out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
               tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
        return np.stack([(o + rnd) >> shift_out for o in out], axis=-1)

    # pass 1: columns (input rows index the frequency u), into the workspace
    ws = one_pass(x.transpose(0, 2, 1), CONST_BITS,
                  CONST_BITS - PASS1_BITS).transpose(0, 2, 1)
    # pass 2: rows
    out = one_pass(ws, CONST_BITS, CONST_BITS + PASS1_BITS + 3)
    return RANGE_LIMIT[out & 1023].reshape(-1, 64)


def upsample(p: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """libjpeg's upsampling of one component plane by (fh, fv): fancy
    (triangular) for h2v1, h1v2 and h2v2, replication otherwise."""
    if (fh, fv) == (1, 1):
        return p
    p = p.astype(np.int32)
    if (fh, fv) == (2, 1) and p.shape[1] > 2:
        return _fancy_h2(p * 3, p, (1, 2), 2).astype(np.uint8)
    if (fh, fv) == (1, 2) or ((fh, fv) == (2, 2) and p.shape[1] > 2):
        above = np.concatenate([p[:1], p[:-1]], axis=0)
        below = np.concatenate([p[1:], p[-1:]], axis=0)
        rows = np.empty((2 * p.shape[0], p.shape[1]), np.int32)
        rows[0::2] = p * 3 + above            # column sums, as jdsample.c
        rows[1::2] = p * 3 + below
        if fh == 1:
            out = np.empty_like(rows)
            out[0::2] = (rows[0::2] + 1) >> 2
            out[1::2] = (rows[1::2] + 2) >> 2
            return out.astype(np.uint8)
        return _fancy_h2(rows * 3, rows, (8, 7), 4).astype(np.uint8)
    return np.repeat(np.repeat(p, fv, axis=0), fh, axis=1).astype(np.uint8)


def _fancy_h2(three_x: np.ndarray, x: np.ndarray, bias, shift: int):
    """Horizontal half of the triangular filter: output 2j from 3*x[j] +
    x[j-1], output 2j+1 from 3*x[j] + x[j+1], biases (left, right), and the
    first and last columns as jdsample.c writes them."""
    h, w = x.shape
    out = np.empty((h, 2 * w), np.int32)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out[:, 0::2] = (three_x + left + bias[0]) >> shift
    out[:, 1::2] = (three_x + right + bias[1]) >> shift
    return out


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert: 16-bit fixed point, tables rounded."""
    one_half = 1 << 15
    y = y.astype(np.int64)
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    r = y + ((91881 * cr + one_half) >> 16)              # FIX(1.40200)
    g = y + ((-22554 * cb - 46802 * cr + one_half) >> 16)  # 0.34414, 0.71414
    b = y + ((116130 * cb + one_half) >> 16)             # FIX(1.77200)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes, name: str = 'JPEG') -> np.ndarray:
    """The bytes of a JPEG -> uint8 [H,W] (grey) or [H,W,3] (RGB)."""
    if data[:2] != b'\xff\xd8':
        raise ValueError(f'{name}: not a JPEG file')
    try:
        return _Decoder(data, name).run()
    except (IndexError, struct.error) as e:
        raise ValueError(f'{name}: truncated or corrupt JPEG ({e})') from e
