"""Bit-exact vectorized PCG32 (reference: include/misaki/core/mathutils.h:89-143).

The reference uses one scalar PCG32 per worker thread (with a clone() quirk
that makes all workers share the same sequence — deliberately NOT replicated,
see SURVEY.md section 7b). Here every wavefront lane gets its
own decorrelated PCG32 stream, seeded from (sample_index, stream_id), so the
render is deterministic for a given seed regardless of device count, chunking,
or sharding. The same streams run on the CPU (the oracle) and the GPU,
bit-exact.

JAX runs without 64-bit integers by default, so the 64-bit PCG state is
carried as two uint32 arrays (hi, lo) and the 64-bit arithmetic is done in
16/32-bit limbs — a handful of integer ops per draw.
"""

from functools import partial

import jax
import jax.numpy as jnp

PCG32_DEFAULT_STATE_HI = 0x853c49e6
PCG32_DEFAULT_STATE_LO = 0x748fea9b
PCG32_DEFAULT_STREAM_HI = 0xda3e39cb
PCG32_DEFAULT_STREAM_LO = 0x94b95bdb
PCG32_MULT_HI = 0x5851f42d
PCG32_MULT_LO = 0x4c957f2d

_u32 = jnp.uint32


def _mul32_wide(a, b):
    """Full 32x32 -> 64 bit product of uint32 arrays, as (hi, lo) uint32."""
    a0 = a & _u32(0xFFFF)
    a1 = a >> _u32(16)
    b0 = b & _u32(0xFFFF)
    b1 = b >> _u32(16)
    t = a0 * b0
    t1 = a1 * b0 + (t >> _u32(16))
    t2 = a0 * b1 + (t1 & _u32(0xFFFF))
    hi = a1 * b1 + (t1 >> _u32(16)) + (t2 >> _u32(16))
    lo = a * b  # wraps mod 2^32 — exactly the low word
    return hi, lo


def _mul64(ah, al, bh, bl):
    """(ah:al) * (bh:bl) mod 2^64 as (hi, lo)."""
    hi, lo = _mul32_wide(al, bl)
    hi = hi + al * bh + ah * bl
    return hi, lo


def _add64(ah, al, bh, bl):
    lo = al + bl
    carry = (lo < al).astype(_u32)
    hi = ah + bh + carry
    return hi, lo


def _step(state_hi, state_lo, inc_hi, inc_lo):
    """One LCG step: state = state * PCG32_MULT + inc."""
    mh, ml = _mul64(state_hi, state_lo, _u32(PCG32_MULT_HI), _u32(PCG32_MULT_LO))
    return _add64(mh, ml, inc_hi, inc_lo)


def _output(old_hi, old_lo):
    """PCG32 XSH-RR output function on the pre-step state."""
    # oldstate >> 18
    s18_lo = (old_lo >> _u32(18)) | (old_hi << _u32(14))
    s18_hi = old_hi >> _u32(18)
    # (oldstate >> 18) ^ oldstate
    x_lo = s18_lo ^ old_lo
    x_hi = s18_hi ^ old_hi
    # (...) >> 27, truncated to 32 bits
    xorshifted = (x_lo >> _u32(27)) | (x_hi << _u32(5))
    rot = old_hi >> _u32(27)  # oldstate >> 59
    return (xorshifted >> rot) | (xorshifted << ((-rot) & _u32(31)))


class PCG32:
    """A vectorized PCG32: state is a pytree of four uint32 arrays.

    All methods are functional — they return (value, new_state) style results
    via the module-level functions below. This class only namespaces them.
    """


def seed(initstate, initseq=1):
    """Per-lane seeding (reference seed(): mathutils.h:96-103).

    initstate / initseq are uint32 arrays (or pairs of arrays for 64-bit
    values given as (hi, lo)); broadcasting applies.
    """
    if isinstance(initstate, tuple):
        is_hi, is_lo = initstate
    else:
        is_hi = jnp.zeros_like(jnp.asarray(initstate, _u32))
        is_lo = jnp.asarray(initstate, _u32)
    if isinstance(initseq, tuple):
        iq_hi, iq_lo = initseq
    else:
        iq_hi = jnp.zeros_like(jnp.asarray(initseq, _u32))
        iq_lo = jnp.asarray(initseq, _u32)

    inc_hi = (iq_hi << _u32(1)) | (iq_lo >> _u32(31))
    inc_lo = (iq_lo << _u32(1)) | _u32(1)
    st_hi = jnp.zeros_like(inc_hi)
    st_lo = jnp.zeros_like(inc_lo)
    st_hi, st_lo = _step(st_hi, st_lo, inc_hi, inc_lo)
    st_hi, st_lo = _add64(st_hi, st_lo, is_hi, is_lo)
    st_hi, st_lo = _step(st_hi, st_lo, inc_hi, inc_lo)
    return {"hi": st_hi, "lo": st_lo, "inc_hi": inc_hi, "inc_lo": inc_lo}


def next_uint32(state):
    old_hi, old_lo = state["hi"], state["lo"]
    new_hi, new_lo = _step(old_hi, old_lo, state["inc_hi"], state["inc_lo"])
    out = _output(old_hi, old_lo)
    return out, {**state, "hi": new_hi, "lo": new_lo}


def next_float32(state):
    """Uniform in [0, 1) via the [1,2) bit trick (mathutils.h:117-127)."""
    bits, state = next_uint32(state)
    f = jax.lax.bitcast_convert_type((bits >> _u32(9)) | _u32(0x3F800000), jnp.float32)
    return f - 1.0, state


def next_2d(state):
    x, state = next_float32(state)
    y, state = next_float32(state)
    return (x, y), state
