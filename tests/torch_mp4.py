"""A reader of MP4 files that hold one MPEG-4 Part 2 video track, for
``tests/test_torch_video.py``: the box tree, the sample table, the
``esds`` descriptors and the stream's VOS / VO / VOL and VOP headers
(ISO/IEC 14496-2 6.2), parsed bit by bit. It reads the files
``cv2.VideoWriter`` (``mp4v``) writes and the port's alike."""

from __future__ import annotations

import struct

CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"dinf", b"edts", b"udta"}


def boxes(data: bytes, start: int = 0, end: int = None, path: str = "") -> list:
    """Every box as (path, offset of its payload, payload), depth first;
    ``path`` joins the types from the top, e.g. ``moov/trak/tkhd``."""
    end = len(data) if end is None else end
    out = []
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            size = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            head = 16
        elif size == 0:
            size = end - pos
        assert size >= head and pos + size <= end, (kind, pos, size)
        name = f"{path}/{kind.decode('latin-1')}" if path else kind.decode("latin-1")
        out.append((name, pos + head, data[pos + head:pos + size]))
        if kind in CONTAINERS:
            out += boxes(data, pos + head, pos + size, name)
        elif kind == b"dref":
            out += boxes(data, pos + head + 8, pos + size, name)
        elif kind == b"stsd":
            out += boxes(data, pos + head + 8, pos + size, name)
        elif kind == b"mp4v":
            out += boxes(data, pos + head + 78, pos + size, name)
        pos += size
    return out


def box(tree: list, name: str) -> bytes:
    """The payload of the one box at ``name``."""
    found = [p for n, _, p in tree if n == name]
    assert len(found) == 1, (name, len(found))
    return found[0]


def _table(payload: bytes, fields: int) -> list:
    """The entries of a full box's table: version/flags, a count, then
    ``fields`` uint32 per entry."""
    n = struct.unpack(">I", payload[4:8])[0]
    flat = struct.unpack(f">{n * fields}I", payload[8:8 + 4 * n * fields])
    return [flat[i:i + fields] if fields > 1 else flat[i] for i in range(0, len(flat), fields)]


def sample_table(data: bytes) -> dict:
    """The track's ``stts``, ``stss``, ``stsc``, ``stsz`` and ``stco``, the
    ``mdat`` payload's offset and size, and each sample's bytes."""
    tree = boxes(data)
    stbl = "moov/trak/mdia/minf/stbl"
    stsz = box(tree, f"{stbl}/stsz")
    uniform, n = struct.unpack(">II", stsz[4:12])
    sizes = [uniform] * n if uniform else list(struct.unpack(f">{n}I", stsz[12:12 + 4 * n]))
    stsc = _table(box(tree, f"{stbl}/stsc"), 3)
    chunks = _table(box(tree, f"{stbl}/stco"), 1)
    offsets = []
    for c, chunk_offset in enumerate(chunks, 1):  # chunk numbers are 1-based
        per = [e[1] for e in stsc if e[0] <= c][-1]
        pos = chunk_offset
        for _ in range(per):
            offsets.append(pos)
            pos += sizes[len(offsets) - 1]
    mdat = [(off, p) for name, off, p in tree if name == "mdat"]
    assert len(mdat) == 1
    return dict(stts=_table(box(tree, f"{stbl}/stts"), 2),
                stss=_table(box(tree, f"{stbl}/stss"), 1) if any(
                    n == f"{stbl}/stss" for n, _, _ in tree) else None,  # None: all sync
                stsc=stsc, stsz=sizes,
                stco=chunks, offsets=offsets, mdat_offset=mdat[0][0], mdat_size=len(mdat[0][1]),
                samples=[data[o:o + s] for o, s in zip(offsets, sizes)], tree=tree)


def esds_info(payload: bytes) -> dict:
    """The ``esds`` box's ES_Descriptor: objectTypeIndication, streamType
    and the DecoderSpecificInfo's bytes."""
    pos = 4  # version, flags

    def descriptor(pos):
        tag = payload[pos]
        pos += 1
        size = 0
        while True:
            b = payload[pos]
            pos += 1
            size = (size << 7) | (b & 0x7F)
            if not b & 0x80:
                return tag, pos, size

    tag, pos, _ = descriptor(pos)
    assert tag == 3, tag  # ES_Descriptor
    flags = payload[pos + 2]
    pos += 3
    assert flags & 0xE0 == 0, flags  # no dependsOn, URL, OCR stream
    tag, pos, _ = descriptor(pos)
    assert tag == 4, tag  # DecoderConfigDescriptor
    oti, stream = payload[pos], payload[pos + 1] >> 2
    pos += 13
    tag, pos, size = descriptor(pos)
    assert tag == 5, tag  # DecoderSpecificInfo
    return dict(object_type=oti, stream_type=stream, dsi=payload[pos:pos + size])


class Bits:
    """MSB-first bit reader."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos * 8

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | ((self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def marker(self):
        assert self.read(1) == 1, f"marker bit at {self.pos - 1}"


def start_codes(data: bytes) -> list:
    """(code, offset after it) of every 00 00 01 xx start code."""
    out, i = [], data.find(b"\x00\x00\x01")
    while i >= 0 and i + 3 < len(data):
        out.append((data[i + 3], i + 4))
        i = data.find(b"\x00\x00\x01", i + 3)
    return out


def parse_headers(dsi: bytes) -> dict:
    """The VOS, VO and VOL headers (and any user data) of a
    DecoderSpecificInfo."""
    info = {"user_data": []}
    codes = start_codes(dsi)
    for k, (code, pos) in enumerate(codes):
        if code == 0xB0:
            info["profile_and_level"] = dsi[pos]
        elif code == 0xB2:
            end = codes[k + 1][1] - 4 if k + 1 < len(codes) else len(dsi)
            info["user_data"].append(dsi[pos:end])
        elif code == 0xB5:
            b = Bits(dsi, pos)
            if b.read(1):
                info["vo_verid"] = b.read(4)
                b.read(3)
            info["visual_object_type"] = b.read(4)
        elif 0x20 <= code <= 0x2F:
            info.update(parse_vol(Bits(dsi, pos)))
    return info


def parse_vol(b: Bits) -> dict:
    vol = {"random_accessible": b.read(1), "video_object_type": b.read(8)}
    verid = 1
    if b.read(1):
        verid = b.read(4)
        b.read(3)
    vol["verid"] = verid
    if b.read(4) == 15:
        b.read(16)
    if b.read(1):
        vol["chroma_format"] = b.read(2)
        vol["low_delay"] = b.read(1)
        assert b.read(1) == 0, "vbv parameters"
    vol["shape"] = b.read(2)
    b.marker()
    vol["time_resolution"] = b.read(16)
    b.marker()
    vol["time_bits"] = max(1, (vol["time_resolution"] - 1).bit_length())
    if b.read(1):
        vol["fixed_vop_time_increment"] = b.read(vol["time_bits"])
    b.marker()
    vol["width"] = b.read(13)
    b.marker()
    vol["height"] = b.read(13)
    b.marker()
    vol["interlaced"] = b.read(1)
    vol["obmc_disable"] = b.read(1)
    vol["sprite_enable"] = b.read(1 if verid == 1 else 2)
    vol["not_8_bit"] = b.read(1)
    vol["quant_type"] = b.read(1)
    vol["quarter_sample"] = b.read(1) if verid != 1 else 0
    vol["complexity_estimation_disable"] = b.read(1)
    vol["resync_marker_disable"] = b.read(1)
    vol["data_partitioned"] = b.read(1)
    if verid != 1:
        vol["newpred"] = b.read(1)
        vol["reduced_resolution"] = b.read(1)
    vol["scalability"] = b.read(1)
    return vol


def parse_vop(sample: bytes, vol: dict) -> dict:
    """The VOP header of one sample: coding type (I / P / B / S),
    modulo_time_base, vop_time_increment, rounding_type, quantiser and
    f_code."""
    vops = [pos for code, pos in start_codes(sample) if code == 0xB6]
    assert len(vops) == 1, vops
    b = Bits(sample, vops[0])
    vop = {"type": "IPBS"[b.read(2)], "modulo_time_base": 0}
    while b.read(1):
        vop["modulo_time_base"] += 1
    b.marker()
    vop["time_increment"] = b.read(vol["time_bits"])
    b.marker()
    vop["coded"] = b.read(1)
    if vop["coded"]:
        if vop["type"] == "P":
            vop["rounding_type"] = b.read(1)
        vop["intra_dc_vlc_thr"] = b.read(3)
        vop["quant"] = b.read(5)
        if vop["type"] != "I":
            vop["f_code"] = b.read(3)
    return vop
