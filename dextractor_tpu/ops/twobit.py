"""2-bit base packing kernels and alphabet translation tables.

The reference packs 4 numeric bases per byte, first base in the two *high*
bits (reference DB.c:319-363, ``COMPRESSED_LEN`` DB.h:255).  Bases beyond a
read's length inside the final byte pack as zero (the C code zeroes the three
bytes past the end before its 4-stride loop, DB.c:329-331).

Alphabet maps replicate the reference lookup tables exactly, including their
quirks (``Number_Arrow`` maps 'G'→2 in addition to '1','2','3'→0,1,2 with a
default of 3 — reference DB.c:418-441).

Two implementations are provided:

- ``*_np``: vectorized NumPy for the host control plane (container assembly,
  tests) — already memory-bandwidth bound on CPU.
- ``pack_2bit``/``unpack_2bit``: jitted JAX for the device data plane.  These
  are pure element-wise shift/mask ops on u8 lanes that XLA fuses with
  neighbouring elementwise stages, so the fused pipeline in ``codecs``
  stays bound by device-memory bandwidth without a dedicated kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


def compressed_len(rlen) -> int:
    """Bytes for a 2-bit packed read: (len+3)>>2 (reference DB.h:255)."""
    return (rlen + 3) >> 2


# ---------------------------------------------------------------------------
# Alphabet translation tables (reference DB.c:367-465)
# ---------------------------------------------------------------------------

def _number_base_table() -> np.ndarray:
    t = np.zeros(256, np.uint8)           # unknown chars -> 0 ('a')
    for i, ch in enumerate(b"acgt"):
        t[ch] = i
        t[ch - 32] = i                     # uppercase
    return t


def _number_arrow_table() -> np.ndarray:
    t = np.full(256, 3, np.uint8)          # default 3 (covers '4')
    t[ord("1")] = 0
    t[ord("2")] = 1
    t[ord("3")] = 2
    t[ord("G")] = 2                        # reference quirk, DB.c:428
    return t


NUMBER_BASE_LUT = _number_base_table()
NUMBER_ARROW_LUT = _number_arrow_table()
LOWER_LUT = np.frombuffer(b"acgt", np.uint8).copy()
UPPER_LUT = np.frombuffer(b"ACGT", np.uint8).copy()
ARROW_LETTER_LUT = np.frombuffer(b"1234", np.uint8).copy()


def _change_case_table() -> np.ndarray:
    """acgt <-> ACGT case toggle (reference Change_Read, DB.c:443-465)."""
    t = np.zeros(256, np.uint8)
    for ch in b"acgt":
        t[ch] = ch - 32
        t[ch - 32] = ch
    return t


CHANGE_CASE_LUT = _change_case_table()


def change_read(seq: np.ndarray) -> np.ndarray:
    """Toggle sequence case (Change_Read)."""
    return CHANGE_CASE_LUT[seq]


def print_read(codes: np.ndarray, width: int = 80) -> bytes:
    """Numeric codes -> lowercase text wrapped at ``width``
    (reference Print_Read, DB.c:1164-1183)."""
    sym = LOWER_LUT[codes]
    out = []
    for i in range(0, len(sym), width):
        out.append(sym[i:i + width].tobytes())
    return b"\n".join(out) + b"\n" if out else b""

_PACK_SHIFTS = np.array([6, 4, 2, 0], np.uint8)


# ---------------------------------------------------------------------------
# NumPy host implementations
# ---------------------------------------------------------------------------

def pack_2bit_np(codes: np.ndarray, lengths: np.ndarray | None = None) -> np.ndarray:
    """Pack (N, L) numeric codes (values 0..3) into (N, L//4) bytes.

    L must be a multiple of 4.  If ``lengths`` is given, positions >= length
    are zeroed first (they may hold padding garbage).
    """
    n, l = codes.shape
    assert l % 4 == 0, "pad L to a multiple of 4"
    if lengths is not None:
        col = np.arange(l, dtype=np.int64)
        codes = np.where(col[None, :] < lengths[:, None], codes, 0)
    quads = codes.reshape(n, l // 4, 4).astype(np.uint8)
    return (
        (quads[..., 0] << 6) | (quads[..., 1] << 4) | (quads[..., 2] << 2) | quads[..., 3]
    )


def unpack_2bit_np(packed: np.ndarray) -> np.ndarray:
    """Unpack (N, C) bytes into (N, 4*C) numeric codes 0..3."""
    n, c = packed.shape
    out = np.empty((n, c, 4), np.uint8)
    out[..., 0] = packed >> 6
    out[..., 1] = (packed >> 4) & 3
    out[..., 2] = (packed >> 2) & 3
    out[..., 3] = packed & 3
    return out.reshape(n, 4 * c)


# ---------------------------------------------------------------------------
# JAX device implementations
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("mask",))
def pack_2bit(codes: jax.Array, lengths: jax.Array | None = None, *, mask: bool = True) -> jax.Array:
    """Device 2-bit pack of (N, L) u8 codes -> (N, L//4) u8 bytes.

    Pure VPU shifts; when ``mask`` and lengths are provided, padding lanes
    are zeroed so the tail byte matches the reference semantics.
    """
    n, l = codes.shape
    if mask and lengths is not None:
        col = jax.lax.broadcasted_iota(jnp.int32, (n, l), 1)
        codes = jnp.where(col < lengths[:, None], codes, jnp.uint8(0))
    quads = codes.reshape(n, l // 4, 4)
    shifted = quads << jnp.array([6, 4, 2, 0], jnp.uint8)
    b = (shifted[..., 0] | shifted[..., 1]) | (shifted[..., 2] | shifted[..., 3])
    return b


@jax.jit
def unpack_2bit(packed: jax.Array) -> jax.Array:
    """Device 2-bit unpack of (N, C) u8 bytes -> (N, 4*C) u8 codes."""
    n, c = packed.shape
    shifts = jnp.array([6, 4, 2, 0], jnp.uint8)
    codes = (packed[..., None] >> shifts) & jnp.uint8(3)
    return codes.reshape(n, 4 * c)


@jax.jit
def unpack_translate(packed: jax.Array, lut: jax.Array) -> jax.Array:
    """Fused 2-bit unpack + letter map: (N, C) u8 -> (N, 4*C) ascii.

    Codes are 2-bit, so the table collapses to one u32 holding the four
    letters and the gather to a variable byte shift; the four per-shift
    letter planes recombine into u32 words whose little-endian bitcast
    IS the interleaved output — no gather, no (N, C, 4) reshape.
    Semantics: ``lut[unpack_2bit(packed)]`` (reference DB.c:342-363 +
    ``Lower/Upper_Read`` DB.c:367-416).
    """
    n, c = packed.shape
    l8 = lut.astype(jnp.uint32)
    lutw = l8[0] | (l8[1] << 8) | (l8[2] << 16) | (l8[3] << 24)
    p = packed.astype(jnp.uint32)
    w = None
    for i, s in enumerate((6, 4, 2, 0)):
        code = (p >> s) & 3
        b = (lutw >> (code << 3)) & 0xFF
        w = b if w is None else w | (b << (8 * i))
    out = jax.lax.bitcast_convert_type(w, jnp.uint8)
    return out.reshape(n, 4 * c)


@functools.partial(jax.jit, static_argnames=("alphabet",))
def pack_translate(rows: jax.Array, lengths: jax.Array,
                   alphabet: str = "base") -> jax.Array:
    """Fused letter map + 2-bit pack: (N, L) ascii -> (N, L//4) u8.

    The exact inverse of ``unpack_translate`` and the same trick: the
    alphabet maps are closed-form bit functions of the character, so the
    256-entry lane-gather (plus the pack's compaction network in the
    Pallas formulation) collapses to a handful of VPU ops.  Per 4 ascii
    bytes: compute each byte's 2-bit code elementwise, bitcast the code
    quad little-endian into one u32 (fields at bits 0/8/16/24), then a
    single multiply by 0x40100401 sums the fields into bits 24-31 as
    ``c0<<6 | c1<<4 | c2<<2 | c3`` — first base in the high bits, no
    cross-field carries (2-bit fields, disjoint partial products).

    alphabet="base": acgt/ACGT -> 0..3, anything else -> 0 (the
    ``Number_Read`` table, reference DB.c:367-416): with x = ch|0x20,
    y = (x>>1)&3 gives a=0 c=1 g=3 t=2 and gray-undo ``y ^ (y>>1)``
    fixes the g/t swap; non-acgt bytes are masked to code 0.
    alphabet="arrow": '1'..'4' -> 0..3 via ch-'1', 'G' -> 2, default 3
    (``Number_Arrow``, DB.c:418-441).

    Positions >= length pack as 0 (reference zeroes the tail bytes
    before its 4-stride loop, DB.c:329-331 via Compress_Read).
    """
    n, l = rows.shape
    assert l % 4 == 0, "pad L to a multiple of 4"
    col = jax.lax.broadcasted_iota(jnp.int32, (n, l), 1)
    inlen = col < lengths[:, None]
    if alphabet == "base":
        low = rows | jnp.uint8(0x20)
        y = (low >> 1) & jnp.uint8(3)
        code = y ^ (y >> 1)
        valid = ((low == jnp.uint8(0x61)) | (low == jnp.uint8(0x63))
                 | (low == jnp.uint8(0x67)) | (low == jnp.uint8(0x74)))
        code = jnp.where(valid & inlen, code, jnp.uint8(0))
    elif alphabet == "arrow":
        y = rows - jnp.uint8(ord("1"))          # u8 wrap: <'1' goes large
        code = jnp.where(y < jnp.uint8(4), y,
                         jnp.where(rows == jnp.uint8(ord("G")),
                                   jnp.uint8(2), jnp.uint8(3)))
        code = jnp.where(inlen, code, jnp.uint8(0))
    else:
        raise ValueError(f"unknown alphabet {alphabet!r}")
    w = jax.lax.bitcast_convert_type(code.reshape(n, l // 4, 4), jnp.uint32)
    return ((w * jnp.uint32(0x40100401)) >> 24).astype(jnp.uint8)


@jax.jit
def translate(data: jax.Array, lut: jax.Array) -> jax.Array:
    """Vectorized 256-entry LUT translation (alphabet maps) on device."""
    return lut[data]
