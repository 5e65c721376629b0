"""Huffman chain decode on the GPU: one lane per chain, Pallas through Triton.

A Huffman stream is bit-serial, so a batch of streams decodes as N
independent chains (ops/decode2).  Here each chain is one lane of a Triton
program: the lane keeps its bit position and last emission width in
registers for its whole walk, reads the two stream words under its bit
position with a per-lane gather from its own row of the word rectangle,
and resolves the code through the two-level tables (decode2.scheme_tables2,
a few KB, so they stay in L1).  The chain state never leaves registers
between symbols; XLA's formulation of the same walk
(decode2.plain_chain / run_chain) is a device while-loop whose every
iteration re-reads the chain state from device memory.

Semantics are exactly the XLA chains' (QV.c:510-691 decode contract):

* plain chains emit one symbol per step, with the type-2 escape literal
  (8 bits after the escape code);
* run chains emit (runlen, literal) token pairs, with 16-bit run-length
  literals after a run code 255 and the segment resume of a checkpoint
  (``pos0`` bit offset, ``carry`` leftover run length whose literal is
  read first);
* every lane carries its own scheme ids (rows of the stacked L1 table), so
  several channels or several codings decode in one launch.

Outputs are written symbol-major (step t of all lanes of a program is one
contiguous store) and transposed to lane-major rows by XLA afterwards.
Steps past a lane's end are masked here, so the kernel may stop each
program at its own longest chain.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .decode2 import _extract, _peek16

# chains per Triton program (one warp).  Small programs spread a batch of a
# few thousand chains over all SMs, and each program stops at its own
# longest chain.
LANES = 32

# Triton computes every load and store offset in int32: a launch's output
# planes (steps x lanes) and its word rectangle (lanes x words) must stay
# under 2^31 elements, so a wider batch is split into several launches.
INDEX_LIMIT = 1 << 31


def _lanes():
    return pl.program_id(0) * LANES + jax.lax.broadcasted_iota(
        jnp.int32, (LANES,), 0)


def _window(rect_ref, base, pos, k: int):
    """The 64-bit stream window (two u32 words) under bit position pos."""
    widx = pos >> 5
    wa = rect_ref[base + jnp.minimum(widx, k - 1)]
    wb = rect_ref[base + jnp.minimum(widx + 1, k - 1)]
    return wa, wb, (pos & 31).astype(jnp.uint32)


def _lookup(f1_ref, f2_ref, sid, cw, subw: int, lmax: int, f2_len: int):
    """(len << 9 | sym) of the 16-bit window cw (decode2._entry_lookup)."""
    e1 = f1_ref[sid * 256 + (cw >> 8)]
    if not subw:
        return e1
    is2 = ((e1 >> 20) & 1) == 1
    idx2 = (e1 & 0xFFFF) * subw + ((cw >> (16 - lmax)) & (subw - 1))
    e2 = f2_ref[jnp.clip(jnp.where(is2, idx2, 0), 0, f2_len - 1)]
    return jnp.where(is2, e2, e1)


def _plain_kernel(rect_ref, rl_ref, sid_ref, sig_ref, p0_ref, f1_ref, f2_ref,
                  out_ref, pos_ref, last_ref, *, k: int, npad: int,
                  subw: int, lmax: int, f2_len: int):
    lanes = _lanes()
    rl = rl_ref[lanes]
    sid = sid_ref[lanes]
    sig = sig_ref[lanes]
    base = lanes * k

    def step(j, carry):
        pos, last = carry
        active = j < rl
        wa, wb, p = _window(rect_ref, base, pos, k)
        e = _lookup(f1_ref, f2_ref, sid, _peek16(wa, wb, p), subw, lmax,
                    f2_len)
        sym = e & 511
        nb = (e >> 9) & 31
        esc = active & (sym == sig)
        sym = jnp.where(esc, _extract(wa, wb, p + nb.astype(jnp.uint32), 8),
                        sym)
        pos = jnp.where(active, pos + jnp.where(esc, nb + 8, nb), pos)
        last = jnp.where(active, jnp.where(esc, 8, nb), last)
        out_ref[j * npad + lanes] = jnp.where(active, sym, 0).astype(
            jnp.uint8)
        return pos, last

    pos, last = jax.lax.fori_loop(0, jnp.max(rl), step,
                                  (p0_ref[lanes], rl * 0))
    pos_ref[lanes] = pos
    last_ref[lanes] = last


def _run_kernel(rect_ref, rl_ref, rsid_ref, ssid_ref, sig_ref, p0_ref,
                carry_ref, f1_ref, f2_ref, runs_ref, lits_ref, ntok_ref,
                pos_ref, last_ref, *, k: int, npad: int, t_max: int,
                subw: int, lmax: int, f2_len: int):
    lanes = _lanes()
    rl = rl_ref[lanes]
    rsid = rsid_ref[lanes]
    ssid = ssid_ref[lanes]
    sig = sig_ref[lanes]
    carry = carry_ref[lanes]
    base = lanes * k

    def cond(c):
        t, _, emitted, _, _ = c
        return (t < t_max) & (jnp.max(jnp.where(emitted < rl, 1, 0)) > 0)

    def body(c):
        t, pos, emitted, last, ntok = c
        active = emitted < rl
        # run token: code [+ 16-bit run-length literal]; a resumed segment
        # starts with the checkpoint's leftover run and no run code
        wa, wb, p = _window(rect_ref, base, pos, k)
        e = _lookup(f1_ref, f2_ref, rsid, _peek16(wa, wb, p), subw, lmax,
                    f2_len)
        c_ = e & 511
        nb = (e >> 9) & 31
        resc = active & (c_ == 255)
        runlen = jnp.where(
            resc, _extract(wa, wb, p + nb.astype(jnp.uint32), 16), c_)
        width = jnp.where(resc, 16, nb)
        phase = (t == 0) & (carry >= 0)
        runlen = jnp.where(phase, carry, runlen)
        resc = resc & ~phase
        pos = pos + jnp.where(active & ~phase,
                              nb + jnp.where(resc, 16, 0), 0)
        emitted1 = jnp.minimum(emitted + runlen, rl)
        # literal token: code [+ 8-bit escape literal]
        need = active & (emitted1 < rl)
        wa, wb, p = _window(rect_ref, base, pos, k)
        e2 = _lookup(f1_ref, f2_ref, ssid, _peek16(wa, wb, p), subw, lmax,
                     f2_len)
        sym = e2 & 511
        snb = (e2 >> 9) & 31
        sesc = need & (sym == sig)
        sym = jnp.where(
            sesc, _extract(wa, wb, p + snb.astype(jnp.uint32), 8), sym)
        pos = pos + jnp.where(need, snb + jnp.where(sesc, 8, 0), 0)
        width = jnp.where(need, jnp.where(sesc, 8, snb), width)
        runs_ref[t * npad + lanes] = jnp.where(active, runlen, 0)
        lits_ref[t * npad + lanes] = jnp.where(need, sym, -1)
        last = jnp.where(active, width, last)
        emitted = jnp.where(active, emitted1 + need.astype(jnp.int32),
                            emitted)
        ntok = jnp.where(active, t + 1, ntok)
        return t + 1, pos, emitted, last, ntok

    z = rl * 0
    _, pos, _, last, ntok = jax.lax.while_loop(
        cond, body, (jnp.int32(0), p0_ref[lanes], z, z, z))
    ntok_ref[lanes] = ntok
    pos_ref[lanes] = pos
    last_ref[lanes] = last


def _pad_lanes(n: int) -> int:
    return max(LANES, -(-n // LANES) * LANES)


def _launches(n: int, width: int):
    """Lane ranges [a, b) of the launches that decode n chains whose
    output plane or rectangle holds ``width`` elements per lane: every
    launch's padded lanes x width stays below INDEX_LIMIT."""
    per = (INDEX_LIMIT - 1) // max(width, 1) // LANES * LANES
    if per < LANES:
        raise ValueError(f"{width} elements per chain leave no room for one "
                         f"program of {LANES} chains under 2^31 offsets")
    return [(a, min(a + per, n)) for a in range(0, max(n, 1), per)]


def _split(launch, n: int, width: int, lane_args, *rest):
    """``launch(*lane_args[a:b], *rest)`` for each lane range of
    ``_launches``, outputs concatenated along the lanes."""
    parts = [launch(*(v[a:b] for v in lane_args), *rest)
             for a, b in _launches(n, width)]
    if len(parts) == 1:
        return parts[0]
    return tuple(jnp.concatenate(p) for p in zip(*parts))


def _lane_args(npad, rect, *vecs):
    """Pad chains to a whole number of programs and flatten the rectangle
    (padding chains have rlen 0 and cost no steps)."""
    n, k = rect.shape
    pad = npad - n
    rect = jnp.pad(rect.astype(jnp.uint32), ((0, pad), (0, 0))).reshape(-1)
    return (rect,) + tuple(jnp.pad(v.astype(jnp.int32), (0, pad))
                           for v in vecs)


def _call(kernel, out_shape, npad, interpret, name):
    return pl.pallas_call(
        kernel, grid=(npad // LANES,), out_shape=out_shape,
        interpret=interpret, backend=None if interpret else "triton",
        compiler_params=None if interpret else plgpu.CompilerParams(
            num_warps=LANES // 32, num_stages=1),
        name=name)


def _plain_launch(rect, rlens, sids, signals, pos0, f1, f2, *, max_len,
                  subw, lmax, interpret):
    n, k = rect.shape
    npad = _pad_lanes(n)
    rect_f, rl, sid, sig, p0 = _lane_args(npad, rect, rlens, sids, signals,
                                          pos0)
    kern = functools.partial(_plain_kernel, k=k, npad=npad, subw=subw,
                             lmax=lmax, f2_len=f2.shape[0])
    out, pos, last = _call(
        kern, (jax.ShapeDtypeStruct((max_len * npad,), jnp.uint8),
                  jax.ShapeDtypeStruct((npad,), jnp.int32),
                  jax.ShapeDtypeStruct((npad,), jnp.int32)),
        npad, interpret, "huffman_plain_chains")(
            rect_f, rl, sid, sig, p0, f1, f2)
    rows = out.reshape(max_len, npad).T[:n]
    col = jax.lax.broadcasted_iota(jnp.int32, (n, max_len), 1)
    rows = jnp.where(col < rlens[:, None], rows, jnp.uint8(0))
    return rows, pos[:n], last[:n]


@functools.partial(jax.jit, static_argnames=("max_len", "subw", "lmax",
                                             "interpret"))
def plain_chains_gpu(rect, rlens, sids, signals, pos0, f1, f2, *,
                     max_len: int, subw: int, lmax: int,
                     interpret: bool = False):
    """Decode N plain Huffman streams, one per rectangle row.

    rect (N, K) u32 stream words (row r starts at word 0 of chain r);
    rlens (N,) symbols per chain (<= max_len); sids (N,) row of ``f1`` per
    chain; signals (N,) escape symbol (255 for type-2 schemes, else 256);
    pos0 (N,) starting bit offset; f1 (S, 256) i32, f2 flat i32 L2 rows
    (decode2.scheme_tables2).  Returns (symbols (N, max_len) u8, total bits
    (N,) i32, last emission width (N,) i32)."""
    n, k = rect.shape
    launch = functools.partial(_plain_launch, max_len=max_len, subw=subw,
                               lmax=lmax, interpret=interpret)
    return _split(launch, n, max(k, max_len),
                  (rect, rlens, sids, signals, pos0),
                  f1.astype(jnp.int32).reshape(-1), f2.astype(jnp.int32))


def _run_launch(rect, rlens, run_sids, sym_sids, signals, pos0, carry, f1,
                f2, *, max_tokens, subw, lmax, interpret):
    n, k = rect.shape
    npad = _pad_lanes(n)
    rect_f, rl, rsid, ssid, sig, p0, cr = _lane_args(
        npad, rect, rlens, run_sids, sym_sids, signals, pos0, carry)
    kern = functools.partial(_run_kernel, k=k, npad=npad, t_max=max_tokens,
                             subw=subw, lmax=lmax, f2_len=f2.shape[0])
    vec = jax.ShapeDtypeStruct((npad,), jnp.int32)
    plane = jax.ShapeDtypeStruct((max_tokens * npad,), jnp.int32)
    runs, lits, ntok, pos, last = _call(
        kern, (plane, plane, vec, vec, vec), npad, interpret,
        "huffman_run_chains")(rect_f, rl, rsid, ssid, sig, p0, cr, f1, f2)
    live = (jax.lax.broadcasted_iota(jnp.int32, (n, max_tokens), 1)
            < ntok[:n, None])
    runs = jnp.where(live, runs.reshape(max_tokens, npad).T[:n], 0)
    lits = jnp.where(live, lits.reshape(max_tokens, npad).T[:n], -1)
    return runs, lits, pos[:n], last[:n]


@functools.partial(jax.jit, static_argnames=("max_tokens", "subw", "lmax",
                                             "interpret"))
def run_chains_gpu(rect, rlens, run_sids, sym_sids, signals, pos0, carry,
                   f1, f2, *, max_tokens: int, subw: int, lmax: int,
                   interpret: bool = False):
    """Decode N RLE Huffman streams into (runlen, literal) token pairs.

    As ``plain_chains_gpu``, with run_sids/sym_sids (N,) the run and symbol
    scheme rows and carry (N,) the resumed run length (-1: start at a run
    code).  Returns (runs (N, T) i32, lits (N, T) i32 with -1 for no
    literal, total bits (N,), last emission width (N,)) with T =
    max_tokens; tokens past a chain's end are (0, -1)."""
    n, k = rect.shape
    launch = functools.partial(_run_launch, max_tokens=max_tokens,
                               subw=subw, lmax=lmax, interpret=interpret)
    return _split(launch, n, max(k, max_tokens),
                  (rect, rlens, run_sids, sym_sids, signals, pos0, carry),
                  f1.astype(jnp.int32).reshape(-1), f2.astype(jnp.int32))
