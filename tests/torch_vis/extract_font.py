#!/usr/bin/env python3
"""Writes ``streamyolo_torch/vis/fonts/Rubik.ttf``, the font cv2 5.0 draws
``FONT_HERSHEY_SIMPLEX`` text with, and its licence note.

cv2 5.0 embeds its fonts in ``cv2.abi3.so`` as gzip members named
``Rubik.ttf``, ``Rubik-Italic.ttf`` and ``WenQuanYiMicroHei.ttf``. This
script finds the member named ``Rubik.ttf`` in the installed cv2's binary,
inflates it with ``zlib``, checks it against ``SHA256`` and writes it, with
``LICENSE.txt`` beside it: the font's own copyright, licence and licence URL
(``name`` table IDs 0, 13 and 14; Rubik is under the SIL Open Font License
1.1). Nothing is downloaded.

    python tests/torch_vis/extract_font.py [--out DIR]

Needs cv2 5.0 (the port does not: it reads the committed file).
"""

from __future__ import annotations

import argparse
import hashlib
import struct
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FONT_DIR = ROOT / "streamyolo_torch" / "vis" / "fonts"
MEMBER = b"Rubik.ttf"
SHA256 = "7cdd1f5e7f04df8091c98e3ff2060b5f0d231b2582e344e7727581b7841c7b77"


def cv2_binary() -> Path:
    import cv2

    binaries = sorted(Path(cv2.__file__).parent.glob("cv2*.so"))
    if not binaries:
        raise FileNotFoundError(f"no cv2 binary beside {cv2.__file__}")
    return binaries[0]


def gzip_member(blob: bytes, name: bytes) -> bytes:
    """The inflated gzip member of ``blob`` whose FNAME is ``name``."""
    at = 0
    while True:
        at = blob.find(b"\x1f\x8b\x08", at)
        if at < 0:
            raise KeyError(f"no gzip member named {name.decode()}")
        flags = blob[at + 3]
        if flags & 0x08:  # FNAME
            p = at + 10
            if flags & 0x04:  # FEXTRA
                p += 2 + struct.unpack_from("<H", blob, p)[0]
            end = blob.find(b"\0", p)
            if blob[p:end] == name:
                return zlib.decompressobj(-zlib.MAX_WBITS).decompress(blob[end + 1:])
        at += 3


def name_records(font: bytes, ids=(0, 13, 14)) -> dict:
    """The Windows Unicode (3, 1, 0x409) strings of ``font``'s name table."""
    tables = struct.unpack_from(">H", font, 4)[0]
    for i in range(tables):
        tag, _, offset, _ = struct.unpack_from(">4sIII", font, 12 + 16 * i)
        if tag == b"name":
            break
    else:
        raise KeyError("no name table")
    _, count, strings = struct.unpack_from(">HHH", font, offset)
    out = {}
    for k in range(count):
        platform, encoding, language, name_id, length, at = struct.unpack_from(
            ">6H", font, offset + 6 + 12 * k)
        if (platform, encoding, language) == (3, 1, 0x409) and name_id in ids:
            raw = font[offset + strings + at:offset + strings + at + length]
            out[name_id] = raw.decode("utf-16-be")
    return out


def licence_note(font: bytes) -> str:
    names = name_records(font)
    return (
        "Rubik.ttf: the Rubik variable font as cv2 5.0 embeds it (its 'sans'\n"
        "face), inflated from cv2's binary by tests/torch_vis/extract_font.py.\n"
        "From the font's own name table:\n\n"
        f"Copyright (name ID 0): {names[0]}\n\n"
        f"License (name ID 13): {names[13]}\n\n"
        f"License URL (name ID 14): {names[14]}\n")


def extract(out_dir: Path = FONT_DIR) -> Path:
    font = gzip_member(cv2_binary().read_bytes(), MEMBER)
    digest = hashlib.sha256(font).hexdigest()
    if digest != SHA256:
        raise ValueError(f"{MEMBER.decode()} in {cv2_binary()} has sha256 {digest}, "
                         f"not the pinned {SHA256}")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "Rubik.ttf").write_bytes(font)
    (out_dir / "LICENSE.txt").write_text(licence_note(font))
    return out_dir / "Rubik.ttf"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=FONT_DIR)
    args = parser.parse_args(argv)
    print(f"wrote {extract(args.out)}")


if __name__ == "__main__":
    main()
