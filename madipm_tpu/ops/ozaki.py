"""Ozaki-scheme fp64 matvec from low-precision dots (error-free slicing).

This module recovers near-fp64 matvec accuracy from pure bf16 (or int8)
matrix passes using the Ozaki splitting (Ozaki et al., "Error-free
transformations of matrix multiplication"; the int8 tensor-core variant is
known as ozIMMU):

1. Each row of A is scaled by a power of two ``e_i`` so entries lie in
   [-1, 1], then decomposed into ``S`` fixed-point slices of ``t = 8``
   bits: ``A_ij = e_i * sum_k a_k[i,j] 2^{-8(k+1)}`` with integer slices
   ``|a_k| <= 2^8`` — exactly representable in bf16 (8-bit significand).
2. The vector x is sliced the same way against a single power-of-two
   scale ``f`` (vector slicing is cheap; it happens per matvec).
3. Every slice-pair product ``a_k[i,j] * b_l[j]`` is an integer below
   2^16 on a common power-of-two grid, so a contraction over a 128-chunk
   accumulates <= 128 * 2^16 = 2^23 in fp32 — EXACTLY.  All rounding is
   confined to the final cross-chunk/cross-pair reduction, performed in
   fp64 on values that are themselves exact.
4. All S^2 slice pairs run as ONE chunked dot_general (one large matmul;
   a triangle truncation of the sub-floor pairs measured slower — see
   :func:`matvec`).

With ``S = 7`` (the default) the result carries ~2^-44 relative accuracy
(vs ~2^-42 for a native-fp64 matvec's n-term accumulation) from 49 bf16
pass-pairs, with the matrix slices precomputed once per solve.  It is an
explicit option (``fp64_matvec="ozaki"``); the default is the exact fp64
product.  S bf16 slices read 2S bytes per matrix entry against 8 for fp64,
so the scheme only pays where fp64 arithmetic, not memory, is the limit.

The reference has no analogue: its GPUs execute fp64 natively
(ext/MadIPMCUDAExt/cuda_wrapper.jl SpMV operators).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

#: slice width in bits.  8 = the bf16 significand; products of two slices
#: fit 16 bits, so a 128-long contraction stays exactly representable in
#: the fp32 accumulator (2^16 * 2^7 = 2^23 < 2^24).
T_BITS = 8
#: number of slices.  The matvec error bound is ~2n * 2^{-8S} relative to
#: rowmax(A) * max|x|: at n = 2048, S = 7 gives ~2^-44 ≈ 6e-14 —
#: comfortably below the PCG's historical 1e-13 corrector floor; S = 6
#: sits at ~1.5e-11 (36 instead of 49 pass-pairs).  Measure solve rate,
#: iteration counts AND the known-optimum rel-KKT certificate before
#: changing it (IPMOptions.ozaki_slices overrides it per solve).
N_SLICES = 7
#: contraction chunk (exactness bound above assumes <= 2^(24-16)).
CHUNK = 128


class SlicedMatrix(NamedTuple):
    """Precomputed Ozaki slices of a (m, n) fp64 matrix.

    slices: (S, C, m, CHUNK) bf16 — integer-valued fixed-point slices with
        the 2^{-8(k+1)} significance folded into the stored values (exact:
        power-of-two scaling).  C = padded n / CHUNK.
    row_scale: (m,) fp64 — per-row power-of-two scale e_i.

    (Arrays only: the tuple is a pytree that crosses jit/vmap boundaries;
    the original column count is recovered from the caller's shapes.)
    """

    slices: jax.Array
    row_scale: jax.Array


def _pow2_scale(mx):
    """Power of two in (mx, 2*mx] (1.0 where mx == 0) — EXACT.

    A one-ulp error in the unsafe direction (scale < mx) would make the
    leading slice overflow bf16's 8-bit significand and silently lose
    exactness, so no ceil(log2)/exp2 (transcendental approximations), and
    no frexp/ldexp either (they lower to s64 bitcasts that not every XLA
    backend accepts).  Instead: round mx UP into fp32 and build
    2^(exponent+1) directly from int32 exponent bits — exact everywhere.

    Values past fp32's exponent range (|A| >= 2^127, < 2^-120) saturate;
    scaled LP/QP data never approaches either end.
    """
    mx = jnp.asarray(mx, jnp.float64)
    m32 = jnp.maximum(
        (mx * (1.0 + 2.0 ** -20)).astype(jnp.float32), jnp.float32(2.0 ** -120)
    )
    expo = (jax.lax.bitcast_convert_type(m32, jnp.int32) >> 23) & 0xFF
    pbits = (jnp.clip(expo + 1, 1, 254) << 23).astype(jnp.int32)
    p32 = jax.lax.bitcast_convert_type(pbits, jnp.float32)
    return jnp.where(mx > 0, p32.astype(jnp.float64), 1.0)


def _fixed_point_slices(v, n_slices: int):
    """Decompose ``v`` (in [-1, 1]) into T_BITS-wide bf16 slices.

    The ONE slicing loop shared by matrix and vector operands — both must
    sit on the same fixed-point grid for products to accumulate exactly.
    Each slice is an integer in [-2^T_BITS, 2^T_BITS] (exact in bf16's
    8-bit significand) times a power-of-two significance folded into the
    stored value (power-of-two scaling is exact in bf16 too).
    """
    sl = []
    scale = 1.0
    for _ in range(n_slices):
        w = jnp.round(v * (2.0 ** T_BITS))
        v = v * (2.0 ** T_BITS) - w
        scale = scale / (2.0 ** T_BITS)
        sl.append((w * scale).astype(jnp.bfloat16))
    return jnp.stack(sl)


def slice_matrix(A, n_slices: int = N_SLICES) -> SlicedMatrix:
    """Decompose fp64 ``A`` (m, n) into exact bf16 fixed-point slices.

    Runs under jit (pure jnp); typically called once at problem-upload
    time (models/qp.py pad_to_device) so the per-iteration matvec only
    slices the *vector* operand.
    """
    A = jnp.asarray(A, jnp.float64)
    m, n = A.shape
    npad = -(-n // CHUNK) * CHUNK
    if npad != n:
        A = jnp.pad(A, ((0, 0), (0, npad - n)))
    e = _pow2_scale(jnp.max(jnp.abs(A), axis=1))  # (m,)
    S = _fixed_point_slices(A / e[:, None], n_slices)  # (S, m, npad)
    S = S.reshape(n_slices, m, npad // CHUNK, CHUNK).transpose(0, 2, 1, 3)
    return SlicedMatrix(slices=S, row_scale=e)


def _slice_vector(x, n_slices: int):
    """Slice fp64 vector (padded length npad) against one power-of-two
    scale; returns ((S, npad) bf16 slices, f scalar)."""
    f = _pow2_scale(jnp.max(jnp.abs(x)))
    return _fixed_point_slices(x / f, n_slices), f


def _pair_block(a_slices, x_slices):
    """All-pairs chunked contraction of slice blocks, reduced in fp64.

    (S, C, m, CHUNK) x (T, C, CHUNK) -> (m,) fp64: contract the chunk lane
    dim exactly in the fp32 accumulator (batch over chunks), then sum the
    exact partials in fp64.
    """
    out = jax.lax.dot_general(
        a_slices,
        x_slices,
        dimension_numbers=(((3,), (2,)), ((1,), (1,))),
        preferred_element_type=jnp.float32,
    )  # (C, S, m, T)
    return jnp.sum(out.astype(jnp.float64), axis=(0, 1, 3))


def matvec(sm: SlicedMatrix, x) -> jax.Array:  # noqa: E302
    """y = A @ x with ~2^{-8(S-1)} relative accuracy from bf16 passes.

    x is fp64 of length C*CHUNK (or shorter; zero-padded).  All S^2
    slice pairs run as ONE chunked dot_general: a triangle truncation
    (pairs s + t >= S contribute below the slicing floor) was measured
    SLOWER despite 30% fewer FLOPs — splitting into three rectangular
    blocks traded one large matmul for three smaller dispatches, so the
    full all-pairs contraction stays.
    """
    S, C, m, _ = sm.slices.shape
    npad = C * CHUNK
    x = jnp.asarray(x, jnp.float64)
    if x.shape[0] > npad:
        raise ValueError(f"x has length {x.shape[0]} > padded columns {npad}")
    if x.shape[0] != npad:
        x = jnp.pad(x, (0, npad - x.shape[0]))
    xs, f = _slice_vector(x, S)  # (S, npad) -> reshape chunked
    xs = xs.reshape(S, C, CHUNK)
    y = _pair_block(sm.slices, xs)
    return sm.row_scale * (f * y)


# ---------------------------------------------------------------------------
# int8 variant: 7-bit slices, int32 accumulation
# ---------------------------------------------------------------------------
#
# Same error-free construction with the slices stored as int8 raw integers
# instead of bf16 fixed-point values:
#
# * slice width drops to 7 bits so every slice (incl. the first, after an
#   extra halving folded into the row scale) lies in [-64, 64] — int8-safe;
# * slice-pair products are <= 2^12 and WOULD accumulate exactly in an
#   int32 s8 x s8 -> s32 dot for contraction lengths n < 2^19 (at n = 2^19
#   a maximal-slice sum reaches 2^31, one past int32 max) — no chunking
#   needed, unlike the bf16 scheme's 128-chunk fp32 accumulator;
# * device-memory traffic halves: 8 slices x 1 byte vs bf16's 7 x 2 B/entry.
#
# The scheme is exact only where the backend lowers the s8 dot to a true
# integer contraction (the CPU does: tests/test_ozaki.py::TestMatvecI8).
# A lowering that rounds the products through a float format breaks the
# >=12-bit-exact premise, so check the accuracy on each new backend.

T8_BITS = 7
N8_SLICES = 8


class SlicedMatrixI8(NamedTuple):
    """int8 Ozaki slices of a (m, n) fp64 matrix.

    slices: (S, m, n) int8 — raw integer slices in [-64, 64]; slice k
        carries significance 2^{-7(k+1)} relative to row_scale.
    row_scale: (m,) fp64 — 2 * e_i (the extra 2 halves the leading slice
        into int8 range).
    """

    slices: jax.Array
    row_scale: jax.Array


def _fixed_point_slices_i8(v, n_slices: int):
    """Decompose ``v`` (in [-1/2, 1/2]) into 7-bit int8 slices.

    v = sum_k w_k 2^{-7(k+1)} + r, |w_k| <= 64, |r| <= 2^{-7S-1}.
    Round-to-nearest keeps every remainder in [-1/2, 1/2] of the next
    slice's grid, so all slices (not just the first) fit int8.
    """
    sl = []
    for _ in range(n_slices):
        w = jnp.round(v * (2.0 ** T8_BITS))
        v = v * (2.0 ** T8_BITS) - w
        sl.append(w.astype(jnp.int8))
    return jnp.stack(sl)


def slice_matrix_i8(A, n_slices: int = N8_SLICES) -> SlicedMatrixI8:
    """Decompose fp64 ``A`` (m, n) into int8 slices (see module notes)."""
    A = jnp.asarray(A, jnp.float64)
    e = _pow2_scale(jnp.max(jnp.abs(A), axis=1))  # (m,)
    S = _fixed_point_slices_i8(A / (2.0 * e[:, None]), n_slices)
    return SlicedMatrixI8(slices=S, row_scale=2.0 * e)


#: pair-significance weights w[s,t] = 2^{-7(s+t+2)} for the fp64 combine.
def _i8_weights(S: int, T: int):
    s = np.arange(S)[:, None]
    t = np.arange(T)[None, :]
    return jnp.asarray(2.0 ** (-T8_BITS * (s + t + 2.0)), jnp.float64)


def matvec_i8(sm: SlicedMatrixI8, x) -> jax.Array:
    """y = A @ x via int8 passes with int32 exact accumulation.

    All S*T slice pairs run as ONE s8 dot_general over the full
    contraction axis (int32 partials stay exact up to length 2^19);
    int32 -> fp64 conversion is exact below 2^53, so the only rounding
    is the final weighted fp64 reduction over the S*T exact partials.
    """
    S, m, n = sm.slices.shape
    if n >= 2 ** 19:
        raise ValueError(
            f"matvec_i8 exactness requires contraction length n < 2^19; got {n}"
        )
    x = jnp.asarray(x, jnp.float64)
    if x.shape[0] > n:
        raise ValueError(f"x has length {x.shape[0]} > matrix columns {n}")
    if x.shape[0] != n:
        x = jnp.pad(x, (0, n - x.shape[0]))
    f = _pow2_scale(jnp.max(jnp.abs(x)))
    xs = _fixed_point_slices_i8(x / (2.0 * f), S)  # (T, n) int8
    P = jax.lax.dot_general(
        sm.slices,
        xs,
        dimension_numbers=(((2,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )  # (S, m, T) int32, exact
    y = jnp.einsum("smt,st->m", P.astype(jnp.float64), _i8_weights(S, S))
    return sm.row_scale * ((2.0 * f) * y)


def matvec_t(sm: SlicedMatrix, v) -> jax.Array:
    """y = A' @ v computed from the FORWARD slices — no transposed slice
    copy stored (halves the device memory of the Ozaki operator pair;
    at m=4096/n=8192 the stored A'-slices alone are ~470 MB/instance).

    A = diag(row_scale) rec with rec the slice reconstruction, so
    A' v = rec' (row_scale * v).  Exactness transposes cleanly: the
    contraction now runs over m, chunked in 128-blocks (pad_to_device
    guarantees m % 128 == 0), so every slice-pair partial stays an
    integer sum <= 128 * 2^16 = 2^23 in the fp32 accumulator — the same
    bound as the forward direction's n-chunking.
    """
    S, C, m, _ = sm.slices.shape
    if m % CHUNK:
        raise ValueError(f"matvec_t requires rows divisible by {CHUNK}; got {m}")
    v = jnp.asarray(v, jnp.float64)
    if v.shape[0] != m:
        raise ValueError(f"v has length {v.shape[0]}, expected {m}")
    w = sm.row_scale * v
    ws, f = _slice_vector(w, S)  # (S, m)
    M = m // CHUNK
    ws = ws.reshape(S, M, CHUNK)
    a = sm.slices.reshape(S, C, M, CHUNK, CHUNK)  # [s, c, mchunk, mlane, nlane]
    out = jax.lax.dot_general(
        a,
        ws,
        dimension_numbers=(((3,), (2,)), ((2,), (1,))),
        preferred_element_type=jnp.float32,
    )  # (M, S, C, CHUNK_n, T)
    y = jnp.sum(out.astype(jnp.float64), axis=(0, 1, 4))  # (C, CHUNK_n)
    return f * y.reshape(C * CHUNK)


def matvec_t_i8(sm: SlicedMatrixI8, v) -> jax.Array:
    """y = A' @ v from the forward int8 slices (CPU-exact variant; the
    contraction over m needs no chunking below 2^19 rows)."""
    S, m, n = sm.slices.shape
    if m >= 2 ** 19:
        raise ValueError(
            f"matvec_t_i8 exactness requires m < 2^19 rows; got {m}"
        )
    v = jnp.asarray(v, jnp.float64)
    if v.shape[0] != m:
        raise ValueError(f"v has length {v.shape[0]}, expected {m}")
    w = sm.row_scale * v
    f = _pow2_scale(jnp.max(jnp.abs(w)))
    ws = _fixed_point_slices_i8(w / (2.0 * f), S)  # (T, m) int8
    P = jax.lax.dot_general(
        sm.slices,
        ws,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )  # (S, n, T) int32, exact
    y = jnp.einsum("snt,st->n", P.astype(jnp.float64), _i8_weights(S, S))
    return (2.0 * f) * y


def slice_any(A, variant: str = "bf16", n_slices=None):
    """Build slices for ``variant`` ("bf16" or "i8").

    ``n_slices`` (bf16 only): override N_SLICES.  6 gives a ~1.5e-11
    relative operator (36 instead of 49 pass-pairs); see
    IPMOptions.ozaki_slices."""
    if variant == "bf16":
        return slice_matrix(A, n_slices or N_SLICES)
    if variant == "i8":
        return slice_matrix_i8(A)
    raise ValueError(f"unknown ozaki variant {variant!r}")


def apply(sm, x) -> jax.Array:
    """Dispatch y = A @ x on the slice container type (trace-time static)."""
    if isinstance(sm, SlicedMatrixI8):
        return matvec_i8(sm, x)
    return matvec(sm, x)


def apply_t(sm, v) -> jax.Array:
    """Dispatch y = A' @ v on the slice container type."""
    if isinstance(sm, SlicedMatrixI8):
        return matvec_t_i8(sm, v)
    return matvec_t(sm, v)
