"""A JPEG writer for the tests: quantized coefficients, given per
component, Huffman-coded into any script of sequential scans (each of any
subset of the components) or spectral-selection progressive scans (a DC
scan of any subset, AC bands of one component), with or without a restart
interval. Each scan gets Huffman tables built from its own symbol counts
(the JPEG standard's Annex K.2 procedure, as libjpeg's
``jpeg_gen_optimal_table``), so codes run from 1 to 16 bits.

cv2 writes only libjpeg's own progressive script; these files hold the
scripts it never writes (sequential non-interleaved scans, a DC scan of
part of the components, AC bands split anywhere, long EOB runs across
restart intervals, bands left out), for ``tests/test_torch_image_progressive.py``
and ``tests/torch_jpeg/make_fixtures.py``.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def geometry(height: int, width: int, sampling: Sequence[Tuple[int, int]]):
    """Per component (width_in_blocks, height_in_blocks, padded width,
    padded height) in blocks, as libjpeg lays out a frame."""
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    out = []
    for h, v in sampling:
        wib = -(-width * h // (8 * hmax))
        hib = -(-height * v // (8 * vmax))
        out.append((wib, hib, -(-wib // h) * h, -(-hib // v) * v))
    return out, hmax, vmax


def random_coefficients(rng, height: int, width: int, sampling, dc_range=60, ac_scale=30,
                        ac_limit=100, empty_share=0.3) -> List[np.ndarray]:
    """[padded height, padded width, 64] int64 natural-order coefficients
    per component: DC values in +-dc_range, AC values whose size falls with
    frequency, at most ac_limit, and a share of blocks with no AC at all
    (EOB runs). Dequantized by tables of at most 8 they stay in the range
    of real images, where libjpeg-turbo's SIMD IDCT (16-bit lanes) equals
    its C IDCT."""
    geo, _, _ = geometry(height, width, sampling)
    out = []
    for _, _, bw, bh in geo:
        zz = np.zeros((bh, bw, 64), np.int64)
        zz[..., 0] = rng.integers(-dc_range, dc_range + 1, (bh, bw))
        scale = ac_scale / (1 + np.arange(1, 64) / 4)
        live = rng.random((bh, bw, 63)) < 0.6 / (1 + np.arange(1, 64) / 8)
        vals = np.round(rng.standard_normal((bh, bw, 63)) * scale).astype(np.int64)
        zz[..., 1:] = np.clip(vals * live, -ac_limit, ac_limit)
        zz[rng.random((bh, bw)) < empty_share, 1:] = 0
        coef = np.zeros_like(zz)
        coef[..., ZIGZAG] = zz
        out.append(coef)
    return out


def optimal_table(freq: Sequence[int]) -> Tuple[List[int], List[int]]:
    """(bits[1..16], values) of a length-limited Huffman code for symbol
    counts ``freq`` (256 entries): Annex K.2, with one code point reserved
    so that no code is all ones."""
    freq = list(freq) + [1]
    codesize = [0] * 257
    others = [-1] * 257
    while True:
        c1 = c2 = -1
        v1 = v2 = None
        for i in range(257):  # the two smallest counts, the larger symbol on ties
            if freq[i]:
                if v1 is None or freq[i] <= v1:
                    c2, v2, c1, v1 = c1, v1, i, freq[i]
                elif v2 is None or freq[i] <= v2:
                    c2, v2 = i, freq[i]
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for i in range(257):
        if codesize[i]:
            bits[codesize[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # the reserved code point
    values = [s for size in range(1, 33) for s in range(256) if codesize[s] == size]
    return bits[1:17], values


def codes(bits: Sequence[int], values: Sequence[int]) -> dict:
    """symbol -> (code, length) of a canonical table."""
    out, code, p = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[values[p]] = (code, length)
            code += 1
            p += 1
        code <<= 1
    return out


def category(v: int) -> Tuple[int, int]:
    """(size, its bits) of a coefficient value, JPEG's magnitude category."""
    size = int(abs(v)).bit_length()
    return size, (v if v >= 0 else v + (1 << size) - 1)


def segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


class _Bits:
    def __init__(self):
        self.out = bytearray()
        self.acc = self.n = 0

    def put(self, value: int, length: int) -> None:
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self) -> None:  # pad with 1-bits
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _scan_tokens(coefs, comps, ss, se, progressive, mcus, restart):
    """The scan's symbols as (table kind, component position, symbol,
    extra bits, their count) and restart points (None entries)."""
    tokens = []
    pred = [0] * len(comps)
    eobrun = 0

    def flush_eobrun():
        nonlocal eobrun
        if eobrun:
            n = eobrun.bit_length() - 1
            tokens.append(("ac", 0, n << 4, eobrun - (1 << n), n))
            eobrun = 0

    for m, blocks in enumerate(mcus):
        if restart and m and m % restart == 0:
            flush_eobrun()
            tokens.append(None)
            pred = [0] * len(comps)
        for pos, (c, by, bx) in blocks:
            zz = coefs[c][by, bx][ZIGZAG]
            if ss == 0:
                diff = int(zz[0]) - pred[pos]
                pred[pos] = int(zz[0])
                size, extra = category(diff)
                tokens.append(("dc", pos, size, extra, size))
            if progressive and ss == 0:
                continue
            run = 0
            for k in range(max(ss, 1), se + 1):
                v = int(zz[k])
                if v == 0:
                    run += 1
                    continue
                if progressive:
                    flush_eobrun()
                while run > 15:
                    tokens.append(("ac", pos, 0xF0, 0, 0))
                    run -= 16
                size, extra = category(v)
                tokens.append(("ac", pos, (run << 4) | size, extra, size))
                run = 0
            if run:
                if progressive:
                    eobrun += 1
                    if eobrun == 0x7FFF:
                        flush_eobrun()
                else:
                    tokens.append(("ac", pos, 0x00, 0, 0))
    flush_eobrun()
    return tokens


def adobe_segment(transform: int) -> bytes:
    """An Adobe APP14 segment (version 100, no flags) naming ``transform``."""
    return segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform))


def header(height: int, width: int, sampling, quant, marker: int, precision: int = 8,
           ids: Optional[Sequence[int]] = None, adobe: Optional[int] = None,
           restart: int = 0) -> bytes:
    """SOI, an Adobe APP14 segment (``adobe`` its transform), a DQT segment
    per table (``quant[c]``, 64 values in natural order, for component
    ``c``; 16-bit entries at 12 bits or where a value needs them), the
    frame header ``marker`` (component ``c`` with id ``ids[c]``, default
    ``c + 1``) and DRI."""
    ids = list(ids) if ids is not None else [c + 1 for c in range(len(sampling))]
    out = bytearray(b"\xff\xd8")
    if adobe is not None:
        out += adobe_segment(adobe)
    for c, q in enumerate(quant):
        q = np.asarray(q, np.int64)[ZIGZAG]
        if precision > 8 or q.max() > 255:
            out += segment(0xDB, bytes([0x10 | c]) + b"".join(struct.pack(">H", int(x)) for x in q))
        else:
            out += segment(0xDB, bytes([c]) + bytes(int(x) for x in q))
    out += segment(marker, struct.pack(">BHHB", precision, height, width, len(sampling))
                   + b"".join(struct.pack(">BBB", ids[c], (h << 4) | v, min(c, len(quant) - 1) if quant else 0)
                              for c, (h, v) in enumerate(sampling)))
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    return bytes(out)


def scan_mcus(height: int, width: int, sampling, comps: Sequence[int]):
    """The MCUs of a scan of ``comps``: for each, [(position in the scan,
    (component, block row, block column))], as libjpeg walks them (one
    component: its own blocks; several: whole MCUs of the frame, dummy
    blocks included)."""
    geo, hmax, vmax = geometry(height, width, sampling)
    if len(comps) == 1:
        c = comps[0]
        wib, hib = geo[c][:2]
        return [[(0, (c, by, bx))] for by in range(hib) for bx in range(wib)]
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    return [[(pos, (c, my * sampling[c][1] + y, mx * sampling[c][0] + x))
             for pos, c in enumerate(comps)
             for y in range(sampling[c][1]) for x in range(sampling[c][0])]
            for my in range(mcuy) for mx in range(mcux)]


def write_jpeg(coefs, height: int, width: int, sampling, quant, script, progressive: bool,
               restart: int = 0, precision: int = 8, ids=None, adobe=None) -> bytes:
    """A JPEG of ``coefs`` (as ``random_coefficients`` gives them) with
    components 1, 2, ... (or ``ids``) at ``sampling`` [(h, v), ...],
    quantization table ``quant[c]`` (64 values, natural order) each, and
    the scans of ``script``: (component indices, Ss, Se), Ah = Al = 0.
    Sequential (SOF0, or SOF1 at a precision other than 8) scans code
    0..63 whatever Ss, Se say. ``adobe``: an APP14 segment's transform."""
    ids = list(ids) if ids is not None else [c + 1 for c in range(len(sampling))]
    marker = 0xC2 if progressive else (0xC0 if precision == 8 else 0xC1)
    out = bytearray(header(height, width, sampling, quant, marker, precision, ids, adobe, restart))
    for comps, ss, se in script:
        mcus = scan_mcus(height, width, sampling, comps)
        tokens = _scan_tokens(coefs, comps, ss, se, progressive, mcus, restart)
        freq = {}
        for t in tokens:
            if t is not None:
                slot = (t[0], t[1])
                freq.setdefault(slot, [0] * 256)[t[2]] += 1
        tables, dht = {}, bytearray()
        for (kind, pos), f in sorted(freq.items()):
            bits, values = optimal_table(f)
            cls = 0 if kind == "dc" else 1
            dht += bytes([(cls << 4) | pos]) + bytes(bits) + bytes(values)
            tables[(kind, pos)] = codes(bits, values)
        if dht:
            out += segment(0xC4, bytes(dht))
        out += segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([ids[c], (pos << 4) | pos]) for pos, c in enumerate(comps))
            + bytes([ss, se, 0]))
        bw, rst = _Bits(), 0
        for t in tokens:
            if t is None:
                bw.flush()
                out += bw.out + bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                bw = _Bits()
                continue
            code, length = tables[(t[0], t[1])][t[2]]
            bw.put(code, length)
            bw.put(t[3], t[4])
        bw.flush()
        out += bw.out
    return bytes(out + b"\xff\xd9")
