"""A JPEG writer for the tests, beside ``tests/torch_jpeg_scans.py``: the
codings and colour models that cv2 reads and libjpeg's default compression
never writes.

  * ``write_arith``: quantized coefficients arithmetic-coded (libjpeg-turbo's
    ``jcarith.c`` QM coder and statistics bins, transcribed) into sequential
    (SOF9) or progressive (SOF10) scans, successive approximation
    included, with a DAC segment's conditioning and a restart interval;
  * ``write_lossless``: sample planes Huffman-coded as a lossless (SOF3)
    file, predictors 1-7 and a point transform;
  * ``header``: the segments before the scans of any frame type, precision,
    component ids and Adobe APP14 transform (``write_jpeg`` of
    ``torch_jpeg_scans`` takes the same keywords);
  * ``read_coefficients``: a one-scan Huffman file's quantized coefficients
    (cv2's baseline files), for transcoding them;
  * ``dct_coefficients``: a sample plane through a float DCT and a table,
    for pixel content in any colour model.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from tests.torch_jpeg_scans import (ZIGZAG, _Bits, adobe_segment, category, codes, geometry, header,
                                     optimal_table, scan_mcus, segment)

# jaricom.c: Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS of each state
# (ITU-T T.81 Table D.2), and the state 113 of fixed probability 0.5
_QM_TABLE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]
# jaricom.c's packing: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS
ARITAB = [(qe << 16) | (nm << 8) | (sw << 7) | nl for qe, nl, nm, sw in _QM_TABLE]


class QMEncoder:
    """jcarith.c's arith_encode, its byte output (carry, stacked 0xFF bytes,
    pending zeros) and finish_pass, into ``out``."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self) -> None:
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _zeros(self) -> None:
        self.out += b"\x00" * self.zc
        self.zc = 0

    def _byte(self, b: int) -> None:
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _carry(self) -> None:
        if self.buffer >= 0:
            self._zeros()
            self._byte(self.buffer + 1)
        self.zc += self.sc  # the carry turns the stacked 0xFF bytes into 0x00
        self.sc = 0

    def _settle(self) -> None:
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self.out.append(self.buffer)
        if self.sc:
            self._zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def encode(self, st: bytearray, i: int, val: int) -> None:
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._settle()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> None:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._settle()
        if self.c & 0x7FFF800:  # the last bytes, unless they are zeros
            self._zeros()
            self._byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)
        self.reset()


def _encode_magnitude(enc: QMEncoder, stats: bytearray, st: int, v: int, ac: bool, k: int = 0,
                      kx: int = 5) -> None:
    """Figures F.8 and F.9 for |v| >= 1 from bin ``st`` (SP or SN; an AC
    value's second decision uses the same bin, then X2 from 189 or 217)."""
    m = 0
    v -= 1
    if v:
        enc.encode(stats, st, 1)
        m = 1
        v2 = v
        if ac:
            v2 >>= 1
            if v2:
                enc.encode(stats, st, 1)
                m <<= 1
                st = 189 if k <= kx else 217
                while True:
                    v2 >>= 1
                    if not v2:
                        break
                    enc.encode(stats, st, 1)
                    m <<= 1
                    st += 1
        else:
            st = 20
            while True:
                v2 >>= 1
                if not v2:
                    break
                enc.encode(stats, st, 1)
                m <<= 1
                st += 1
    enc.encode(stats, st, 0)
    st += 14
    while True:
        m >>= 1
        if not m:
            break
        enc.encode(stats, st, 1 if m & v else 0)


def _arith_scan(coefs, mcus, slots, ss, se, ah, al, progressive, restart, dac) -> bytes:
    """One scan's entropy-coded bytes (restart markers included): jcarith.c
    encode_mcu for a sequential scan, encode_mcu_DC_first / _DC_refine /
    _AC_first / _AC_refine for a progressive one."""
    enc = QMEncoder()
    fixed = bytearray([113])
    dc_stats = {t: bytearray(64) for t, _ in slots}
    ac_stats = {t: bytearray(256) for _, t in slots}
    ncomp = len(slots)
    last_dc, context = [0] * ncomp, [0] * ncomp
    do_dc = not progressive or (ss == 0 and ah == 0)
    do_ac = not progressive or ss > 0
    out = bytearray()

    def reset_stats():
        for pos, (dt, at) in enumerate(slots):
            if do_dc:
                dc_stats[dt][:] = bytes(64)
                last_dc[pos] = context[pos] = 0
            if do_ac:
                ac_stats[at][:] = bytes(256)

    def dc_first(pos, stats, m):
        lo, hi = dac.get(("dc", slots[pos][0]), (0, 1))
        st = context[pos]
        v = m - last_dc[pos]
        if v == 0:
            enc.encode(stats, st, 0)
            context[pos] = 0
            return
        last_dc[pos] = m
        enc.encode(stats, st, 1)
        sign = int(v < 0)
        enc.encode(stats, st + 1, sign)
        v = abs(v)
        # the conditioning from the magnitude category
        mag = 1 << max(0, (v - 1).bit_length() - 1) if v > 1 else 0
        if mag < (1 << lo) >> 1:
            context[pos] = 0
        elif mag > (1 << hi) >> 1:
            context[pos] = 12 + 4 * sign
        else:
            context[pos] = 4 + 4 * sign
        _encode_magnitude(enc, stats, st + 2 + sign, v, False)

    def ac_band(stats, zz, start, end, kx):
        """Figure F.5 / G.1.3.2 over zz[start..end] (already shifted by Al)."""
        ke = end
        while ke >= start and zz[ke] == 0:
            ke -= 1
        k = start
        while k <= ke:
            st = 3 * (k - 1)
            enc.encode(stats, st, 0)
            while zz[k] == 0:
                enc.encode(stats, st + 1, 0)
                st += 3
                k += 1
            enc.encode(stats, st + 1, 1)
            v = zz[k]
            enc.encode(fixed, 0, int(v < 0))
            _encode_magnitude(enc, stats, st + 2, abs(v), True, k, kx)
            k += 1
        if k <= end:
            enc.encode(stats, 3 * (k - 1), 1)

    def ac_refine(stats, zz, start, end):
        """Figure G.10: zz are the coefficients' magnitudes' signs and bits."""
        def bit_at(v, shift):
            return abs(v) >> shift
        ke = end
        while ke > 0 and bit_at(zz[ke], al) == 0:
            ke -= 1
        kex = ke
        while kex > 0 and bit_at(zz[kex], ah) == 0:
            kex -= 1
        k = start
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                enc.encode(stats, st, 0)
            while True:
                v = bit_at(zz[k], al)
                if v:
                    if v >> 1:
                        enc.encode(stats, st + 2, v & 1)
                    else:
                        enc.encode(stats, st + 1, 1)
                        enc.encode(fixed, 0, int(zz[k] < 0))
                    break
                enc.encode(stats, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= end:
            enc.encode(stats, 3 * (k - 1), 1)

    rst = 0
    for m, blocks in enumerate(mcus):
        if restart and m and m % restart == 0:
            enc.finish()
            out += enc.out + bytes([0xFF, 0xD0 + rst])
            enc.out = bytearray()
            rst = (rst + 1) & 7
            reset_stats()
        for pos, (c, by, bx) in blocks:
            zz = [int(x) for x in coefs[c][by, bx][ZIGZAG]]
            dt, at = slots[pos]
            kx = dac.get(("ac", at), 5)
            if not progressive:
                dc_first(pos, dc_stats[dt], zz[0])
                ac_band(ac_stats[at], zz, 1, 63, kx)
            elif ss == 0 and ah == 0:
                dc_first(pos, dc_stats[dt], zz[0] >> al)
            elif ss == 0:
                enc.encode(fixed, 0, (zz[0] >> al) & 1)
            elif ah == 0:
                shifted = [0] + [(abs(v) >> al) * (1 if v >= 0 else -1) for v in zz[1:]]
                ac_band(ac_stats[at], shifted, ss, se, kx)
            else:
                ac_refine(ac_stats[at], zz, ss, se)
    enc.finish()
    return bytes(out + enc.out)


def write_arith(coefs, height: int, width: int, sampling, quant, script, progressive: bool,
                restart: int = 0, dac: Optional[Dict] = None, tables=None, precision: int = 8,
                ids=None, adobe=None) -> bytes:
    """An arithmetic-coded JPEG (SOF9, or SOF10 if ``progressive``) of
    ``coefs`` (``torch_jpeg_scans.random_coefficients``' layout) and the
    scans of ``script``: (components, Ss, Se, Ah, Al). Component ``c``
    codes with the statistics of table ``tables[c]`` (default 0 for the
    first component, 1 for the others, as libjpeg assigns them), and
    ``dac`` {("dc", slot): (L, U), ("ac", slot): Kx} is written as a DAC
    segment (the defaults are L 0, U 1, Kx 5)."""
    dac = dict(dac or {})
    tables = list(tables) if tables is not None else [0] + [1] * (len(sampling) - 1)
    out = bytearray(header(height, width, sampling, quant, 0xCA if progressive else 0xC9,
                           precision, ids, adobe, restart))
    if dac:
        body = bytearray()
        for (kind, slot), val in sorted(dac.items()):
            if kind == "dc":
                body += bytes([slot, (val[1] << 4) | val[0]])
            else:
                body += bytes([0x10 | slot, val])
        out += segment(0xCC, bytes(body))
    for comps, ss, se, ah, al in script:
        slots = [(tables[c], tables[c]) for c in comps]
        out += segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([(ids[c] if ids else c + 1), (tables[c] << 4) | tables[c]]) for c in comps)
            + bytes([ss, se, (ah << 4) | al]))
        out += _arith_scan(coefs, scan_mcus(height, width, sampling, comps), slots, ss, se, ah, al,
                           progressive, restart, dac)
    return bytes(out + b"\xff\xd9")


# libjpeg's default progressive script for 3 components (jcparam.c
# jpeg_simple_progression) and for 1
SIMPLE_PROGRESSION_3 = [([0, 1, 2], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([2], 1, 63, 0, 1),
                        ([1], 1, 63, 0, 1), ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1),
                        ([0, 1, 2], 0, 0, 1, 0), ([2], 1, 63, 1, 0), ([1], 1, 63, 1, 0),
                        ([0], 1, 63, 1, 0)]
SIMPLE_PROGRESSION_1 = [([0], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([0], 6, 63, 0, 2),
                        ([0], 1, 63, 2, 1), ([0], 0, 0, 1, 0), ([0], 1, 63, 1, 0)]


# ---------------------------------------------------------------- lossless


def predict(psv: int, ra, rb, rc):
    """T.81 Table H.1 (libjpeg-turbo's jdlossls.c PREDICTOR1..7)."""
    return {1: lambda: ra, 2: lambda: rb, 3: lambda: rc, 4: lambda: ra + rb - rc,
            5: lambda: ra + ((rb - rc) >> 1), 6: lambda: rb + ((ra - rc) >> 1),
            7: lambda: (ra + rb) >> 1}[psv]()


def lossless_differences(plane: np.ndarray, precision: int, psv: int, pt: int,
                         reset_rows: Sequence[int] = ()) -> np.ndarray:
    """The differences a lossless encoder codes for ``plane`` (samples
    already shifted right by ``pt``): the first row (and each row of
    ``reset_rows``, where a restart interval begins) predicted from the
    left, its first sample from 2^(P - Pt - 1), every other row's first
    sample from above, the rest by predictor ``psv``; modulo 2^16."""
    x = plane.astype(np.int64)
    pred = np.empty_like(x)
    for r in range(x.shape[0]):
        if r == 0 or r in reset_rows:
            pred[r, 0] = 1 << (precision - pt - 1)
            pred[r, 1:] = x[r, :-1]
        else:
            pred[r, 0] = x[r - 1, 0]
            pred[r, 1:] = predict(psv, x[r, :-1], x[r - 1, 1:], x[r - 1, :-1])
    return (x - pred) & 0xFFFF


def write_lossless(planes: Sequence[np.ndarray], height: int, width: int, sampling,
                   precision: int, psv: int, pt: int = 0, restart_rows: int = 0, ids=None,
                   adobe=None, scans=None) -> bytes:
    """A lossless Huffman-coded JPEG (SOF3): ``planes[c]`` the component's
    samples at its own size (ceil(width * h / hmax) x ceil(height * v /
    vmax)), in the scans of ``scans`` (lists of components; default one
    interleaved scan of all), each padded to its whole MCUs by repeating
    the last column and row, with a restart interval of ``restart_rows``
    MCU rows (a DRI segment before each scan). Each component of a scan
    gets a table built from its own symbol counts."""
    _, hmax, vmax = geometry(height, width, sampling)
    ids = list(ids) if ids is not None else [c + 1 for c in range(len(sampling))]
    out = bytearray(header(height, width, sampling, [], 0xC3, precision, ids, adobe))
    for comps in scans or [list(range(len(sampling)))]:
        if len(comps) == 1:  # a lone component's MCU is one sample
            mcuy, mcux = np.asarray(planes[comps[0]]).shape
            grid = [(1, 1)]
        else:
            mcux, mcuy = -(-width // hmax), -(-height // vmax)
            grid = [sampling[c] for c in comps]
        diffs = []
        for c, (h, v) in zip(comps, grid):
            p = np.asarray(planes[c], np.int64) >> pt
            p = np.pad(p, ((0, mcuy * v - p.shape[0]), (0, mcux * h - p.shape[1])), mode="edge")
            resets = range(0, mcuy * v, restart_rows * v) if restart_rows else ()
            diffs.append(lossless_differences(p, precision, psv, pt, resets))
        tokens = []  # (scan position, size, extra bits) or None at a restart
        for my in range(mcuy):
            if restart_rows and my and my % restart_rows == 0:
                tokens.append(None)
            for mx in range(mcux):
                for pos, (h, v) in enumerate(grid):
                    for y in range(v):
                        for x in range(h):
                            d = int(diffs[pos][my * v + y, mx * h + x])
                            d = d - 0x10000 if d > 0x8000 else d
                            size, extra = (16, 0) if d == 0x8000 else category(d)
                            tokens.append((pos, size, extra))
        freq = [[0] * 256 for _ in comps]
        for t in tokens:
            if t is not None:
                freq[t[0]][t[1]] += 1
        if restart_rows:
            out += segment(0xDD, struct.pack(">H", restart_rows * mcux))
        tables, dht = [], bytearray()
        for pos in range(len(comps)):
            bits, values = optimal_table(freq[pos])
            dht += bytes([pos]) + bytes(bits) + bytes(values)
            tables.append(codes(bits, values))
        out += segment(0xC4, bytes(dht))
        out += segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([ids[c], pos << 4]) for pos, c in enumerate(comps)) + bytes([psv, 0, pt]))
        bw, rst = _Bits(), 0
        for t in tokens:
            if t is None:
                bw.flush()
                out += bw.out + bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                bw = _Bits()
                continue
            code, length = tables[t[0]][t[1]]
            bw.put(code, length)
            if 0 < t[1] < 16:
                bw.put(t[2], t[1])
        bw.flush()
        out += bw.out
    return bytes(out + b"\xff\xd9")


# ---------------------------------------------------------------- coefficients


class _BitReader:
    def __init__(self, data: bytes, pos: int):
        self.data, self.pos, self.acc, self.n = data, pos, 0, 0

    def bit(self) -> int:
        if self.n == 0:
            b = self.data[self.pos]
            if b == 0xFF:
                nxt = self.data[self.pos + 1]
                if nxt == 0:
                    self.pos += 1
                else:
                    raise ValueError(f"marker 0xFF{nxt:02X} inside the scan")
            self.pos += 1
            self.acc, self.n = b, 8
        self.n -= 1
        return (self.acc >> self.n) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def restart(self) -> None:
        self.n = 0
        assert self.data[self.pos] == 0xFF and 0xD0 <= self.data[self.pos + 1] <= 0xD7
        self.pos += 2


def read_coefficients(buf: bytes):
    """(height, width, sampling [(h, v)], quantization tables by component,
    [padded block rows, padded block columns, 64] natural-order coefficients
    by component) of a one-scan Huffman-coded file (SOF0 / SOF1) that holds
    every component in its scan, as cv2 writes them."""
    p, quant, dc, ac, restart = 2, {}, {}, {}, 0
    while True:
        marker = buf[p + 1]
        length = struct.unpack(">H", buf[p + 2:p + 4])[0]
        s = buf[p + 4:p + 2 + length]
        p += 2 + length
        if marker == 0xDB:
            o = 0
            while o < len(s):
                pq, tq = s[o] >> 4, s[o] & 15
                vals = (struct.unpack(f">{64}H", s[o + 1:o + 129]) if pq else tuple(s[o + 1:o + 65]))
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = vals
                quant[tq] = q
                o += 1 + 64 * (pq + 1)
        elif marker == 0xC4:
            o = 0
            while o < len(s):
                tc, th = s[o] >> 4, s[o] & 15
                bits = list(s[o + 1:o + 17])
                values = list(s[o + 17:o + 17 + sum(bits)])
                table = {(length_, code): sym for sym, (code, length_) in codes(bits, values).items()}
                (ac if tc else dc)[th] = table
                o += 17 + sum(bits)
        elif marker in (0xC0, 0xC1):
            height, width = struct.unpack(">HH", s[1:5])
            comps = [(s[6 + 3 * i], s[7 + 3 * i] >> 4, s[7 + 3 * i] & 15, s[8 + 3 * i])
                     for i in range(s[5])]
        elif marker == 0xDD:
            restart = struct.unpack(">H", s[:2])[0]
        elif marker == 0xDA:
            ns = s[0]
            slots = [(s[2 + 2 * i] >> 4, s[2 + 2 * i] & 15) for i in range(ns)]
            break
    sampling = [(h, v) for _, h, v, _ in comps]
    geo, _, _ = geometry(height, width, sampling)
    coefs = [np.zeros((bh, bw, 64), np.int64) for _, _, bw, bh in geo]
    mcus = scan_mcus(height, width, sampling, list(range(len(comps))))
    br = _BitReader(buf, p)

    def decode(table):
        code = length = 0
        while True:
            code = (code << 1) | br.bit()
            length += 1
            if (length, code) in table:
                return table[(length, code)]

    def extend(v, s):
        return v - (1 << s) + 1 if v < (1 << (s - 1)) else v

    pred = [0] * len(comps)
    for m, blocks in enumerate(mcus):
        if restart and m and m % restart == 0:
            br.restart()
            pred = [0] * len(comps)
        for pos, (c, by, bx) in blocks:
            zz = np.zeros(64, np.int64)
            s = decode(dc[slots[pos][0]])
            if s:
                pred[pos] += extend(br.bits(s), s)
            zz[0] = pred[pos]
            k = 1
            while k < 64:
                rs = decode(ac[slots[pos][1]])
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    zz[k] = extend(br.bits(s), s)
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    break
            coefs[c][by, bx, ZIGZAG] = zz
    return height, width, sampling, [quant[tq] for _, _, _, tq in comps], coefs


def dct_coefficients(plane: np.ndarray, quant, blocks: Tuple[int, int],
                     level: int = 128) -> np.ndarray:
    """[rows, cols, 64] natural-order coefficients of ``plane`` (edge
    padded to ``blocks`` = (rows, cols) of 8x8 blocks) through a float
    DCT-II less ``level``, divided by ``quant`` and rounded."""
    rows, cols = blocks
    p = np.asarray(plane, np.float64)
    p = np.pad(p, ((0, 8 * rows - p.shape[0]), (0, 8 * cols - p.shape[1])), mode="edge") - level
    k = np.arange(8)
    basis = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * np.where(k == 0, np.sqrt(0.5), 1)[:, None] / 2
    b = p.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)
    d = np.einsum("ui,rcij,vj->rcuv", basis, b, basis).reshape(rows, cols, 64)
    return np.round(d / np.asarray(quant, np.float64)).astype(np.int64)


def four_component_frame(buf: bytes, transform: int) -> bytes:
    """A one-scan 3-component Huffman-coded file (cv2's baseline frames) as
    a 4-component frame of the same size with an Adobe APP14 segment of
    ``transform`` (0: CMYK, 2: YCCK): the frame header gains a fourth
    component (id 4, 1x1, table 0) and the file a second scan of it in
    which every block is a DC difference of 0 and an EOB (one-code tables),
    so the first three components keep the file's own entropy-coded data
    and the fourth is 128 everywhere. What ``chip_smoke.py`` times as a
    full-size CMYK frame, built there from the committed baseline frame."""
    p = 2
    out = bytearray(b"\xff\xd8") + adobe_segment(transform)
    while True:
        marker = buf[p + 1]
        length = struct.unpack(">H", buf[p + 2:p + 4])[0]
        seg = buf[p:p + 2 + length]
        if marker in (0xC0, 0xC1):
            _, height, width, ncomp = struct.unpack(">BHHB", seg[4:10])
            assert ncomp == 3, "a 3-component frame"
            hmax = max(b >> 4 for b in seg[11:19:3])
            vmax = max(b & 15 for b in seg[11:19:3])
            body = seg[4:9] + bytes([4]) + seg[10:] + bytes([4, 0x11, 0])
            seg = segment(marker, body)
        if marker == 0xDA:
            break
        out += seg
        p += 2 + length
    end = buf.rindex(b"\xff\xd9")
    blocks = -(-width // (8 * hmax)) * -(-height // (8 * vmax))
    one_code = bytes([1] + [0] * 15)
    out += buf[p:end]
    out += segment(0xC4, bytes([0x02]) + one_code + b"\x00" + bytes([0x12]) + one_code + b"\x00")
    out += segment(0xDA, bytes([1, 4, 0x22, 0, 63, 0]))
    out += bytes(-(-2 * blocks // 8)) + b"\xff\xd9"  # each block: code 0, code 0
    return bytes(out)
