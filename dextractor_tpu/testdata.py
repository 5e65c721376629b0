"""Synthetic PacBio-style inputs made from a seed: .fasta, .arrow, .quiva
and subreads BAM images.

Used by the tests, the benchmark and the chip smoke run; importing this
module has no side effects.
"""

import numpy as np


def make_fasta(rng, n_reads=20, min_len=0, max_len=700, movie=b"m130205_1210_42", width=80,
               with_rq=True, well_jumps=False):
    """A synthetic PacBio-style .fasta image plus its parsed fields."""
    lines = []
    well = 0
    for i in range(n_reads):
        well += int(rng.integers(0, 600 if well_jumps else 3))
        rlen = int(rng.integers(min_len, max_len + 1))
        beg = int(rng.integers(0, 100))
        end = beg + rlen
        qv = int(rng.integers(0, 1000))
        hdr = f">{movie.decode()}/{well}/{beg}_{end}"
        if with_rq:
            hdr += f" RQ=0.{qv}"
        lines.append(hdr.encode())
        seq = rng.choice(np.frombuffer(b"acgt", np.uint8), size=rlen)
        for j in range(0, rlen, width):
            lines.append(seq[j:j + width].tobytes())
        if rlen == 0:
            pass
    return b"\n".join(lines) + b"\n"


def make_arrow(rng, n_reads=20, min_len=0, max_len=700, movie=b"m130205_1210_42", width=80):
    lines = []
    well = 0
    for i in range(n_reads):
        well += int(rng.integers(0, 3))
        rlen = int(rng.integers(min_len, max_len + 1))
        beg = int(rng.integers(0, 100))
        end = beg + rlen
        snr = rng.uniform(0.5, 120.0, size=4)
        hdr = (f">{movie.decode()}/{well}/{beg}_{end} "
               f"SN={snr[0]:.2f},{snr[1]:.2f},{snr[2]:.2f},{snr[3]:.2f}")
        lines.append(hdr.encode())
        seq = rng.choice(np.frombuffer(b"1234", np.uint8), size=rlen)
        for j in range(0, rlen, width):
            lines.append(seq[j:j + width].tobytes())
    return b"\n".join(lines) + b"\n"


def make_bam(rng, n_reads=8, min_len=50, max_len=300, movie=b"m54238_180903_1",
             with_qv=True, with_pw=True, gz=True, lengths=None):
    """A minimal PacBio subreads BAM image (+ the expected per-record fields).

    ``lengths`` overrides the uniform [min_len, max_len] draw with explicit
    per-read lengths (e.g. a log-normal PacBio mix)."""
    import gzip
    import struct

    seq_code = np.zeros(256, np.uint8)          # BAM 4-bit base codes
    seq_code[np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)] = np.arange(16)
    recs = []
    body = bytearray()
    well = 0
    if lengths is not None:
        n_reads = len(lengths)
    for i in range(n_reads):
        well += int(rng.integers(0, 3))
        ln = (int(lengths[i]) if lengths is not None
              else int(rng.integers(min_len, max_len + 1)))
        beg = int(rng.integers(0, 100))
        end = beg + ln
        qname = b"%s/%d/%d_%d" % (movie, well, beg, end)
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=ln).tobytes()
        rq = float(np.float32(rng.uniform(0.6, 1.0)))
        snr = rng.uniform(3, 12, 4).astype(np.float32)
        pw = rng.integers(1, 7, ln).astype(np.uint8)
        # dq/iq/mq/sq are FASTQ-encoded QVs; dt is a base tag (acgt + 'n')
        dq = (rng.integers(33, 80, ln)).astype(np.uint8)
        dt = rng.choice(np.frombuffer(b"acgt", np.uint8), size=ln)
        dt[dq == 70] = ord("n")
        qvs = [dq.tobytes(), dt.tobytes(),
               bytes((rng.integers(33, 80, ln)).astype(np.uint8)),
               bytes((rng.integers(33, 80, ln)).astype(np.uint8)),
               bytes((rng.integers(33, 80, ln)).astype(np.uint8))]
        tagbuf = bytearray()

        def tag_i(t, v):
            tagbuf.extend(t + b"i" + struct.pack("<i", v))

        def tag_f(t, v):
            tagbuf.extend(t + b"f" + struct.pack("<f", v))

        def tag_Z(t, v):
            tagbuf.extend(t + b"Z" + v + b"\x00")

        def tag_Bf(t, arr):
            tagbuf.extend(t + b"B" + b"f" + struct.pack("<i", len(arr)))
            tagbuf.extend(np.asarray(arr, "<f4").tobytes())

        def tag_BC(t, arr):
            tagbuf.extend(t + b"B" + b"C" + struct.pack("<i", len(arr)))
            tagbuf.extend(np.asarray(arr, np.uint8).tobytes())

        tag_i(b"qs", beg)
        tag_i(b"qe", end)
        tag_f(b"rq", rq)
        tag_i(b"np", int(rng.integers(1, 20)))
        tag_Bf(b"sn", snr)
        if with_pw:
            tag_BC(b"pw", pw)
        if with_qv:
            for t, v in zip((b"dq", b"dt", b"iq", b"mq", b"sq"), qvs):
                tag_Z(t, v)

        packed = np.zeros((ln + 1) // 2, np.uint8)
        idx = seq_code[np.frombuffer(seq, np.uint8)]
        packed[: (ln // 2)] = (idx[0:ln - 1:2] << 4) | idx[1:ln:2]
        if ln % 2:
            packed[-1] = idx[-1] << 4
        rec = bytearray()
        rec += struct.pack("<iiBBHHHiii", -1, -1, len(qname) + 1, 255, 0, 0,
                           4, ln, -1, -1)
        rec += struct.pack("<i", 0)
        rec += qname + b"\x00"
        rec += packed.tobytes()
        rec += b"\xff" * ln
        rec += bytes(tagbuf)
        body += struct.pack("<i", len(rec)) + bytes(rec)
        recs.append(dict(qname=qname, well=well, beg=beg, end=end, ln=ln,
                         seq=seq, rq=rq, snr=snr, pw=pw, qvs=qvs))

    header_text = b"@HD\tVN:1.5\tSO:unknown\n"
    bam = (b"BAM\x01" + struct.pack("<i", len(header_text)) + header_text
           + struct.pack("<i", 0) + bytes(body))
    if gz:
        bam = gzip.compress(bam)
    return bam, recs


def bgzf_compress(data: bytes, block: int = 0xFF00) -> bytes:
    """Genuine BGZF framing: <=64KB-input gzip members each carrying the
    BC/BSIZE extra field, terminated by the canonical 28-byte EOF block
    (the framing htslib bgzip writes)."""
    import struct
    import zlib

    out = bytearray()
    for i in range(0, len(data), block):
        chunk = data[i:i + block]
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        payload = co.compress(chunk) + co.flush()
        bsize = len(payload) + 25
        out += (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                + struct.pack("<H", 6)              # XLEN
                + b"BC" + struct.pack("<HH", 2, bsize)
                + payload
                + struct.pack("<II", zlib.crc32(chunk), len(chunk)))
    out += bytes.fromhex(
        "1f8b08040000000000ff0600424302001b0003000000000000000000")
    return bytes(out)


def make_quiva(rng, n_reads=12, min_len=0, max_len=400, movie=b"m130205_1210_42",
               del_run=True, sub_heavy=False, spread=30, lengths=None):
    """A synthetic .quiva image: header + 5 equal-length QV/tag streams.

    delTag contains 'n' exactly where delQV equals one designated char so the
    delChar discovery in the scan matches real instrument output.
    ``lengths`` overrides the uniform [min_len, max_len] draw with explicit
    per-read lengths (e.g. a log-normal PacBio mix).
    """
    del_char = ord("f")
    lines = []
    well = 0
    if lengths is not None:
        n_reads = len(lengths)
    for i in range(n_reads):
        well += int(rng.integers(0, 3))
        rlen = (int(lengths[i]) if lengths is not None
                else int(rng.integers(min_len, max_len + 1)))
        beg = int(rng.integers(0, 50))
        end = beg + rlen
        qv = int(rng.integers(0, 1000))
        lines.append(f"@{movie.decode()}/{well}/{beg}_{end} RQ=0.{qv}".encode())
        if del_run:
            # runs of del_char broken by other chars
            delqv = np.full(rlen, del_char, np.uint8)
            breaks = rng.random(rlen) < 0.25
            delqv[breaks] = rng.integers(ord("!"), ord("!") + spread, size=int(breaks.sum()))
        else:
            delqv = rng.integers(ord("!"), ord("!") + spread, size=rlen).astype(np.uint8)
        tag = rng.choice(np.frombuffer(b"acgt", np.uint8), size=rlen)
        tag[delqv == del_char] = ord("n")
        ins = rng.integers(ord("!"), ord("!") + spread, size=rlen).astype(np.uint8)
        mrg = rng.integers(ord("!"), ord("!") + spread, size=rlen).astype(np.uint8)
        if sub_heavy:
            sub = np.full(rlen, ord("k"), np.uint8)
            breaks = rng.random(rlen) < 0.2
            sub[breaks] = rng.integers(ord("!"), ord("!") + spread, size=int(breaks.sum()))
        else:
            sub = rng.integers(ord("!"), ord("!") + spread, size=rlen).astype(np.uint8)
        for stream in (delqv, tag, ins, mrg, sub):
            lines.append(stream.tobytes())
    return b"\n".join(lines) + b"\n"
