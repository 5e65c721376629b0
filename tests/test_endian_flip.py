"""Opposite-endian container decode.

Portability is an explicit reference contract (README.md:34-35): a file
written on a big-endian machine carries byte-swapped keys, header ints,
scheme codebits, and u32 stream words; the decoder detects the swapped
endian key and flips every multi-byte field on the fly (undexta.c:140-159,
QV.c:322-375 Read_Scheme + the GETFLIP stream macro).

These tests synthesize byte-flipped images exactly per that spec — swap the
u16 keys, the i32/u16 header fields, each scheme's u32 codebits, and every
u32 bitstream word, while leaving raw byte payloads (2-bit packs, well
deltas, prefixes) untouched — and assert the decoders reproduce the
original text byte-for-byte.
"""

import struct

import numpy as np
import pytest

from conftest import make_fasta, make_arrow, make_quiva

from dextractor_tpu.codecs.twobit_codec import (
    encode_fasta_to_dexta, decode_dexta_to_fasta,
    encode_arrow_to_dexar, decode_dexar_to_arrow,
)
from dextractor_tpu.codecs.qv_codec import (
    scan_quiva, create_qvcoding, decode_dexqv_to_quiva,
    DEL, TAG, INS, MRG, SUB,
)
from dextractor_tpu.formats.dexta import read_dexta
from dextractor_tpu.formats.quiva import parse_quiva
from dextractor_tpu.formats.dexqv import CONTAINER_KEY, CODEC_KEY
from dextractor_tpu.ops import bitstream as bs
from dextractor_tpu.ops import twobit as tb


def _flip_dexta_image(data: bytes, arrow: bool = False) -> bytes:
    """Rebuild a parsed .dexta/.dexar as its big-endian-written twin."""
    d = read_dexta(data, arrow=arrow)
    out = bytearray()
    out += struct.pack(">H", 0x55AA)
    out += struct.pack(">i", len(d.prefix))
    out += d.prefix
    offs = d.payload.offsets
    last = 0
    for i in range(len(d.wells)):
        dlt = int(d.wells[i]) - last
        last = int(d.wells[i])
        while dlt >= 255:
            out.append(0xFF)
            dlt -= 255
        out.append(dlt)
        if arrow:
            out += struct.pack(">ii4H", int(d.begs[i]), int(d.ends[i]),
                               *[int(x) for x in d.cnrs[i]])
        else:
            out += struct.pack(">iii", int(d.begs[i]), int(d.ends[i]),
                               int(d.qvs[i]))
        out += d.payload.flat[offs[i]: offs[i + 1]].tobytes()
    return bytes(out)


def test_dexta_flip_decode():
    rng = np.random.default_rng(21)
    fasta = make_fasta(rng, n_reads=15, min_len=0, max_len=600,
                       well_jumps=True)
    enc = encode_fasta_to_dexta(fasta)
    flipped = _flip_dexta_image(enc, arrow=False)
    assert flipped != enc
    assert decode_dexta_to_fasta(flipped) == fasta


def test_dexar_flip_decode():
    rng = np.random.default_rng(22)
    arrow = make_arrow(rng, n_reads=12, min_len=1, max_len=500)
    enc = encode_arrow_to_dexar(arrow)
    flipped = _flip_dexta_image(enc, arrow=True)
    assert decode_dexar_to_arrow(flipped) == decode_dexar_to_arrow(enc)


def test_dexta_legacy_flip_decode():
    """Legacy 0x33cc containers carry uint16 fields; flipped twin reads via
    the 0xcc33 key path (undexta.c:144-147, 211-240)."""
    rng = np.random.default_rng(23)
    fasta = make_fasta(rng, n_reads=10, min_len=0, max_len=400)
    enc = encode_fasta_to_dexta(fasta)
    d = read_dexta(enc)
    offs = d.payload.offsets
    out = bytearray()
    out += struct.pack(">H", 0x33CC)
    out += struct.pack(">i", len(d.prefix))
    out += d.prefix
    last = 0
    for i in range(len(d.wells)):
        dlt = int(d.wells[i]) - last
        last = int(d.wells[i])
        while dlt >= 255:
            out.append(0xFF)
            dlt -= 255
        out.append(dlt)
        out += struct.pack(">3H", int(d.begs[i]), int(d.ends[i]),
                           int(d.qvs[i]))
        out += d.payload.flat[offs[i]: offs[i + 1]].tobytes()
    assert decode_dexta_to_fasta(bytes(out)) == fasta


def _flipped_scheme_bytes(s) -> bytes:
    out = bytearray([s.type & 0xFF])
    for i in range(256):
        l = int(s.codelens[i])
        out.append(l & 0xFF)
        if l > 0:
            out += int(s.codebits[i]).to_bytes(4, "big")
    return bytes(out)


def _flipped_dexqv(quiva: bytes) -> bytes:
    """Encode a .quiva as a big-endian machine would have written it."""
    q = parse_quiva(quiva)
    stats = scan_quiva(q)
    c = create_qvcoding(stats, q.prefix, False)

    out = bytearray()
    out += struct.pack(">H", CONTAINER_KEY)
    out += struct.pack(">H", CODEC_KEY)
    out += struct.pack(">H", 256 if c.del_char < 0 else c.del_char)
    out += struct.pack(">H", 256 if c.sub_char < 0 else c.sub_char)
    out += struct.pack(">i", len(c.prefix))
    out += c.prefix
    out += _flipped_scheme_bytes(c.del_scheme)
    if c.del_char >= 0:
        out += _flipped_scheme_bytes(c.drun_scheme)
    out += _flipped_scheme_bytes(c.ins_scheme)
    out += _flipped_scheme_bytes(c.mrg_scheme)
    out += _flipped_scheme_bytes(c.sub_scheme)
    if c.sub_char >= 0:
        out += _flipped_scheme_bytes(c.srun_scheme)

    offs = np.zeros(q.n_entries + 1, np.int64)
    np.cumsum(q.lengths, out=offs[1:])
    last_well = 0
    for i in range(q.n_entries):
        dlt = int(q.wells[i]) - last_well
        last_well = int(q.wells[i])
        while dlt >= 255:
            out.append(0xFF)
            dlt -= 255
        out.append(dlt)
        out += struct.pack(">iii", int(q.begs[i]), int(q.ends[i]),
                           int(q.qvs[i]))
        s, e = offs[i], offs[i + 1]
        delqv = q.streams[DEL, s:e]
        tag = q.streams[TAG, s:e]
        if c.del_char < 0:
            out += bs.encode_stream(c.del_scheme, delqv).byteswap().tobytes()
            kept = tag
        else:
            out += bs.encode_run_stream(
                c.del_scheme, c.drun_scheme, delqv,
                c.del_char).byteswap().tobytes()
            kept = tag[delqv != c.del_char]
        codes = tb.NUMBER_BASE_LUT[kept]
        tlen = (len(codes) + 3) >> 2
        if tlen:
            padded = np.zeros(4 * tlen, np.uint8)
            padded[: len(codes)] = codes
            out += tb.pack_2bit_np(padded[None, :])[0].tobytes()
        out += bs.encode_stream(c.ins_scheme,
                                q.streams[INS, s:e]).byteswap().tobytes()
        out += bs.encode_stream(c.mrg_scheme,
                                q.streams[MRG, s:e]).byteswap().tobytes()
        if c.sub_char < 0:
            out += bs.encode_stream(c.sub_scheme,
                                    q.streams[SUB, s:e]).byteswap().tobytes()
        else:
            out += bs.encode_run_stream(
                c.sub_scheme, c.srun_scheme, q.streams[SUB, s:e],
                c.sub_char).byteswap().tobytes()
    return bytes(out)


def test_dexqv_flip_decode():
    """Flipped .dexqv: scheme codebits and stream words byteswapped; the
    Python walker (the only flip-capable path, qv_codec.py) must reproduce
    the original text exactly."""
    rng = np.random.default_rng(24)
    quiva = make_quiva(rng, n_reads=12, min_len=1, max_len=400)
    flipped = _flipped_dexqv(quiva)
    assert decode_dexqv_to_quiva(flipped, native=True) == quiva
    assert decode_dexqv_to_quiva(flipped, native=False) == quiva


def test_dexqv_flip_decode_no_delchar():
    """Flip with plain del/sub channels (no RLE schemes serialized)."""
    rng = np.random.default_rng(25)
    quiva = make_quiva(rng, n_reads=8, min_len=1, max_len=200,
                       del_run=False)
    flipped = _flipped_dexqv(quiva)
    assert decode_dexqv_to_quiva(flipped) == quiva


def test_dexqv_flip_device_decode_raises():
    """device=True never decodes on the host: a flipped container, which
    only the host walkers read, raises instead; the default policy sends
    it to the host walker."""
    from dextractor_tpu.utils.errors import FormatError

    rng = np.random.default_rng(26)
    quiva = make_quiva(rng, n_reads=4, min_len=1, max_len=100)
    flipped = _flipped_dexqv(quiva)
    with pytest.raises(FormatError, match="device=False"):
        decode_dexqv_to_quiva(flipped, device=True)
    assert decode_dexqv_to_quiva(flipped) == quiva
