"""Sparse device problem representation for large instances.

The reference keeps the Jacobian sparse end-to-end: CSR/CSC with a COO->CSR
value map (src/utils.jl:158-207), a host symbolic analysis of the normal
matrix ``A Sigma^-1 A'`` (``build_normal_system``, src/utils.jl:209-274), a
per-iteration numeric assembly kernel (``assemble_normal_system!``,
src/utils.jl:276-308; GPU row-intersection kernel
ext/MadIPMCUDAExt/cuda_wrapper.jl:108-144), and CUSPARSE SpMV operators
(ext/MadIPMCUDAExt/cuda_wrapper.jl:43-94).

This module is the JAX equivalent, built for XLA instead of pointer
chasing:

- **ELL storage** (row-padded ``[m, K]`` values + column indices, and the
  transpose ``[n, Kc]``): SpMV/SpMV' become one gather + one lane reduction,
  fully static shapes, vmap-able.
- **Host symbolic analysis** (:func:`build_normal_pattern`): for every
  column ``j`` of A, all ordered nonzero-row pairs ``(r_a >= r_b)``
  contribute ``A_aj * A_bj * dinv_j`` to ``S[r_a, r_b]``.  The pair list is
  sorted by destination once on host; the device never branches.
- **Per-iteration numeric assembly** (inside ``SparseDeviceQP
  .assemble_normal_matrix``): two gathers -> product -> sorted
  ``segment_sum`` -> one static scatter into the dense padded ``S``.  Cost
  is O(sum_j nnz_j^2) instead of the dense path's O(m^2 n) matmul, and the
  full dense ``A`` (m x n) is never materialized — ``n`` can be two orders
  of magnitude larger than the dense path allows.

The factorization of ``S`` (size m) stays dense (cuSOLVER on the GPU); this
path targets the tall/sparse regime (n >> m, few nnz per row) typical of
standard-form LPs.

**Sparse QPs** go through the K1 CONDENSED formulation: the same pair-list
machinery assembles ``A' diag(w) A`` (the pattern of AᵀA is the normal
pattern of Aᵀ) and the quadratic term ``Q`` is held in ELL for SpMV plus a
static scatter-add into the dense condensed matrix.  The reference's
equivalent capability is ``SparseKKTSystem``+cuDSS on sparse QPs
(src/utils.jl:110, ext/MadIPMCUDAExt/); its ``NormalKKTSystem`` is likewise
LP-only (src/KKT/normalkkt.jl:40-43).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from .qp import QuadraticModel, _round_up


class NormalPattern(NamedTuple):
    """Host-precomputed symbolic structure of S = A D A' (lower triangle).

    All arrays are int32.  ``pair_*`` have length P = sum_j k_j (k_j + 1)/2
    (k_j = nnz of column j); ``s_low``/``s_up`` have length nnzS (unique
    lower-triangle entries of S, as flat indices into the padded m*m)."""

    pair_a: np.ndarray  # flat ELL index of the first factor A[r_a, j]
    pair_b: np.ndarray  # flat ELL index of the second factor A[r_b, j]
    pair_col: np.ndarray  # j (gathers dinv)
    seg_id: np.ndarray  # sorted segment id into the unique entries
    s_low: np.ndarray  # destination r_a * m_pad + r_b  (r_a >= r_b)
    s_up: np.ndarray  # mirror r_b * m_pad + r_a (== s_low on the diagonal)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseDeviceQP:
    """Padded ELL-sparse standard-form LP on device.

    Field-compatible with :class:`DeviceQP` for everything the solver
    kernels touch (c, b, bounds, masks, x0/y0) — the Jacobian is consumed
    only through the operator methods shared with the dense class."""

    c: jax.Array  # [n]
    b: jax.Array  # [m]
    lb: jax.Array  # [n]
    ub: jax.Array  # [n]
    c0: jax.Array  # scalar
    row_mask: jax.Array  # [m] bool
    col_mask: jax.Array  # [n] bool
    x0: jax.Array  # [n]
    y0: jax.Array  # [m]

    # ELL Jacobian, row-major and transposed
    A_val: jax.Array  # [m, K]
    A_col: jax.Array  # [m, K] int32 (padded slots: col 0, val 0)
    AT_val: jax.Array  # [n, Kc]
    AT_row: jax.Array  # [n, Kc] int32

    # Normal-equation symbolic pattern (device copies of NormalPattern;
    # zero-length when only the condensed pattern was built)
    pair_a: jax.Array
    pair_b: jax.Array
    pair_col: jax.Array
    seg_id: jax.Array
    s_low: jax.Array
    s_up: jax.Array

    Q: Optional[jax.Array] = None  # never a dense matrix on this path

    # ELL quadratic term (full symmetric), None for an LP
    Q_val: Optional[jax.Array] = None  # [n, Kq]
    Q_col: Optional[jax.Array] = None  # [n, Kq] int32

    # Condensed (K1) symbolic pattern of A'A = normal pattern of A'
    # (zero-length unless built by pad_sparse_to_device(kkt="condensed"))
    cpair_a: Optional[jax.Array] = None
    cpair_b: Optional[jax.Array] = None
    cpair_col: Optional[jax.Array] = None  # constraint row r (gathers w)
    cseg_id: Optional[jax.Array] = None
    c_low: Optional[jax.Array] = None  # flat n_pad*n_pad destinations
    c_up: Optional[jax.Array] = None

    # ------------------------------------------------------------------
    @property
    def n(self) -> int:
        return self.c.shape[-1]

    @property
    def m(self) -> int:
        return self.b.shape[-1]

    @property
    def is_qp(self) -> bool:
        return self.Q_val is not None

    @property
    def free_mask(self) -> jax.Array:
        return self.col_mask & (self.lb < self.ub)

    @property
    def has_lb(self) -> jax.Array:
        return self.free_mask & jnp.isfinite(self.lb)

    @property
    def has_ub(self) -> jax.Array:
        return self.free_mask & jnp.isfinite(self.ub)

    # Jacobian operator interface --------------------------------------
    @property
    def dtype(self):
        return self.c.dtype

    @property
    def dense_A(self) -> jax.Array:
        raise NotImplementedError(
            "the sparse path supports the NORMAL (LP) and CONDENSED (K1) "
            "KKT systems; use the dense representation for AUGMENTED/K2 "
            "solves (those materialize the full [Sigma+Q, A'; A, del_c] "
            "block matrix)"
        )

    def matvec(self, x) -> jax.Array:
        """A @ x: one gather along lanes + reduction (CUSPARSE SpMV role)."""
        return jnp.sum(self.A_val * x[self.A_col], axis=1)

    def rmatvec(self, y) -> jax.Array:
        """A' @ y via the transposed ELL (no atomics, unlike a scatter)."""
        return jnp.sum(self.AT_val * y[self.AT_row], axis=1)

    def row_inf_norm(self) -> jax.Array:
        return jnp.max(jnp.abs(self.A_val), axis=1)

    def scale_rows(self, con_scale) -> "SparseDeviceQP":
        return dataclasses.replace(
            self,
            A_val=self.A_val * con_scale[:, None],
            AT_val=self.AT_val * con_scale[self.AT_row],
        )

    def assemble_normal_matrix(self, dinv, factor_dtype) -> jax.Array:
        """Numeric assembly of S = A diag(dinv) A' into a dense padded m x m.

        The reference's ``assemble_normal_system!`` re-walked row
        intersections per entry; here the host-sorted pair list turns the
        whole assembly into gather -> multiply -> sorted segment_sum -> one
        static scatter (plus its mirror), all with static shapes."""
        m = self.m
        flatA = self.A_val.astype(factor_dtype).reshape(-1)
        contrib = (
            flatA[self.pair_a]
            * flatA[self.pair_b]
            * dinv.astype(factor_dtype)[self.pair_col]
        )
        nnz_s = self.s_low.shape[0]
        # Padding contract (batched buckets, parallel/batch.py): padded pair
        # slots carry seg_id == nnz_s (out of range -> dropped by
        # segment_sum); padded destination slots carry s_low/s_up == m*m
        # (out of bounds -> dropped by mode="drop").
        snz = jax.ops.segment_sum(
            contrib, self.seg_id, num_segments=nnz_s, indices_are_sorted=True
        )
        S = jnp.zeros((m * m,), factor_dtype)
        # s_up == s_low on the diagonal: the second scatter rewrites the
        # same value, which .set tolerates.
        S = S.at[self.s_low].set(snz, mode="drop").at[self.s_up].set(snz, mode="drop")
        return S.reshape(m, m)

    # Quadratic-term operator interface (sparse counterpart of DeviceQP's;
    # consumed by the K1 CONDENSED formulation, ops/kkt.py) --------------
    def qmatvec(self, x) -> jax.Array:
        """Q @ x through the full-symmetric ELL (zeros for an LP)."""
        if self.Q_val is None:
            return jnp.zeros_like(x)
        return jnp.sum(self.Q_val * x[self.Q_col], axis=1)

    def scale_quad(self, obj_scale) -> "SparseDeviceQP":
        if self.Q_val is None:
            return self
        return dataclasses.replace(self, Q_val=self.Q_val * obj_scale)

    def live_rows(self) -> jax.Array:
        free = self.free_mask
        contrib = self.A_val * self.A_val * jnp.where(free[self.A_col], 1.0, 0.0)
        return self.row_mask & (jnp.sum(contrib, axis=1) > 0)

    def assemble_ata(self, w, factor_dtype) -> jax.Array:
        """A' diag(w) A over free columns into a dense padded n x n.

        Same gather -> multiply -> sorted segment_sum -> static scatter as
        :meth:`assemble_normal_matrix`, over the transposed pattern (the
        pattern of A'A is the normal pattern of A')."""
        if self.cpair_a is None or self.cpair_a.shape[0] == 0:
            raise NotImplementedError(
                "this SparseDeviceQP was packed without the condensed "
                "pattern; rebuild with pad_sparse_to_device(kkt='condensed')"
            )
        n = self.n
        free = self.free_mask
        flatAT = (
            self.AT_val * jnp.where(free, 1.0, 0.0)[:, None]
        ).astype(factor_dtype).reshape(-1)
        contrib = (
            flatAT[self.cpair_a]
            * flatAT[self.cpair_b]
            * w.astype(factor_dtype)[self.cpair_col]
        )
        nnz_c = self.c_low.shape[0]
        cnz = jax.ops.segment_sum(
            contrib, self.cseg_id, num_segments=nnz_c, indices_are_sorted=True
        )
        C = jnp.zeros((n * n,), factor_dtype)
        C = C.at[self.c_low].set(cnz, mode="drop").at[self.c_up].set(cnz, mode="drop")
        return C.reshape(n, n)

    def add_quad(self, C, factor_dtype) -> jax.Array:
        """C + Q masked to free columns, via one static scatter-add (padded
        ELL slots carry value 0 at column 0 — they add zero)."""
        if self.Q_val is None:
            return C
        n = self.n
        free = self.free_mask
        rows = jnp.arange(n, dtype=jnp.int32)[:, None]
        dst = (rows * n + self.Q_col).reshape(-1)
        mask = free[self.Q_col] & free[:, None]
        vals = jnp.where(mask, self.Q_val, 0.0).astype(factor_dtype).reshape(-1)
        return C.reshape(-1).at[dst].add(vals).reshape(n, n)


# ---------------------------------------------------------------------------
# Host-side construction
# ---------------------------------------------------------------------------


def _to_ell(A: sp.csr_matrix, rows_pad: int, cols_pad: int, k_pad_mult: int = 8,
            k_width: Optional[int] = None):
    """CSR -> padded ELL ([rows_pad, K] values/indices) plus, for each CSR
    nonzero in order, its flat ELL position (rows * K + slot).  ``k_width``
    forces the padded lane width (batched buckets need one shared K)."""
    m = A.shape[0]
    counts = np.diff(A.indptr)
    K = int(counts.max()) if counts.size and counts.max() > 0 else 1
    K = _round_up(K, k_pad_mult)
    if k_width is not None:
        if k_width < K:
            raise ValueError(f"k_width {k_width} < required {K}")
        K = k_width
    val = np.zeros((rows_pad, K), dtype=np.float64)
    idx = np.zeros((rows_pad, K), dtype=np.int32)
    # slot of each nonzero within its row = position - indptr[row]
    rows = np.repeat(np.arange(m), counts)
    slots = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    val[rows, slots] = A.data
    idx[rows, slots] = A.indices
    ell_pos = (rows * K + slots).astype(np.int64)
    return val, idx, ell_pos


def build_normal_pattern(A: sp.csr_matrix, ell_pos: np.ndarray, m_pad: int) -> NormalPattern:
    """Symbolic analysis of S = A D A' (reference ``build_normal_system``,
    src/utils.jl:209-274, two-pass count+fill with a dense bitmask; here a
    sorted pair list consumed by segment_sum), given the CSR->ELL position
    map from :func:`_to_ell`.

    Cost: P = sum_j k_j (k_j + 1) / 2 pairs.  Dense columns blow P up
    quadratically — the same structural weakness normal equations have in
    the reference; presolve/standard form keep k_j small in practice."""
    m, n = A.shape
    # CSC traversal with CSR positions: tag each CSR nonzero with its
    # position, convert to CSC; csc.data then holds CSR positions per column.
    tag = sp.csr_matrix(
        (np.arange(A.nnz, dtype=np.int64), A.indices, A.indptr), shape=A.shape
    )
    csc = tag.tocsc()
    csc.sort_indices()
    col_counts = np.diff(csc.indptr)

    pair_a_parts, pair_b_parts, pair_col_parts = [], [], []
    out_i_parts, out_j_parts = [], []
    # Group columns by nnz count so the tril-index template is built once
    # per k (vectorized over all columns sharing it).
    for k in np.unique(col_counts):
        if k == 0:
            continue
        cols = np.flatnonzero(col_counts == k)
        # positions/rows per column, shape [ncols, k] (CSC is row-sorted)
        starts = csc.indptr[cols]
        take = starts[:, None] + np.arange(k)[None, :]
        pos_k = csc.data[take]  # CSR positions
        row_k = csc.indices[take]  # row ids, ascending per column
        ii, bb = np.tril_indices(int(k))  # ii >= bb -> r_a >= r_b
        pair_a_parts.append(ell_pos[pos_k[:, ii]].ravel())
        pair_b_parts.append(ell_pos[pos_k[:, bb]].ravel())
        pair_col_parts.append(np.repeat(cols, ii.size))
        out_i_parts.append(row_k[:, ii].ravel())
        out_j_parts.append(row_k[:, bb].ravel())

    if not pair_a_parts:
        # degenerate: empty A
        z = np.zeros(0, dtype=np.int32)
        return NormalPattern(z, z, z, z, z, z)

    pair_a = np.concatenate(pair_a_parts)
    pair_b = np.concatenate(pair_b_parts)
    pair_col = np.concatenate(pair_col_parts)
    out_i = np.concatenate(out_i_parts)
    out_j = np.concatenate(out_j_parts)

    key = out_i.astype(np.int64) * m_pad + out_j
    order = np.argsort(key, kind="stable")
    key = key[order]
    uniq, seg_id = np.unique(key, return_inverse=True)
    s_low = uniq
    ui = uniq // m_pad
    uj = uniq % m_pad
    s_up = uj * m_pad + ui

    return NormalPattern(
        pair_a=pair_a[order].astype(np.int32),
        pair_b=pair_b[order].astype(np.int32),
        pair_col=pair_col[order].astype(np.int32),
        seg_id=seg_id.astype(np.int32),
        s_low=s_low.astype(np.int32),
        s_up=s_up.astype(np.int32),
    )


def pad_sparse_to_device(
    qp: QuadraticModel,
    dtype=jnp.float64,
    pad_multiple: int = 128,
    m_pad: Optional[int] = None,
    n_pad: Optional[int] = None,
    ell_k: Optional[int] = None,
    ell_kt: Optional[int] = None,
    ell_kq: Optional[int] = None,
    pattern_p: Optional[int] = None,
    pattern_nnzs: Optional[int] = None,
    cpattern_p: Optional[int] = None,
    cpattern_nnzs: Optional[int] = None,
    kkt: Optional[str] = None,
) -> SparseDeviceQP:
    """Pack a host equality-form LP/QP into a padded ELL SparseDeviceQP
    (sparse counterpart of :func:`madipm_tpu.models.qp.pad_to_device`).

    ``kkt`` selects which symbolic pattern(s) to precompute: ``"normal"``
    (S = A D A', LP only), ``"condensed"`` (C = A' w A, the K1/QP path) or
    ``"both"``; default: condensed when Q is present, normal otherwise.

    The optional size overrides (``ell_k``/``ell_kt``/``ell_kq`` lane
    widths, ``pattern_p``/``pattern_nnzs``/``cpattern_*`` pair/destination
    counts) let a batch of different sparsity patterns share one padded
    shape for vmapping (parallel/batch.bucket_pad_sparse); padded pattern
    slots are marked with out-of-range indices that the device assembly
    drops."""
    if kkt is None:
        kkt = "condensed" if qp.Q is not None else "normal"
    if kkt not in ("normal", "condensed", "both"):
        raise ValueError(f"kkt must be 'normal', 'condensed' or 'both', got {kkt!r}")
    if qp.Q is not None and kkt == "normal":
        raise ValueError(
            "the NORMAL pattern is LP-only; pack sparse QPs with "
            "kkt='condensed' (K1)"
        )
    if np.any(qp.lcon != qp.ucon):
        raise ValueError(
            "pad_sparse_to_device requires equality-only constraints; run slack_form first"
        )
    m, n = qp.ncon, qp.nvar
    mp = m_pad if m_pad is not None else _round_up(m, pad_multiple)
    np_ = n_pad if n_pad is not None else _round_up(n, pad_multiple)
    if mp < m or np_ < n:
        raise ValueError("padded shape smaller than problem")

    A = qp.A.tocsr()
    A.sort_indices()
    A.sum_duplicates()
    A.eliminate_zeros()

    val, idx, ell_pos = _to_ell(A, mp, np_, k_width=ell_k)
    AT = A.T.tocsr()
    AT.sort_indices()
    tval, tidx, t_ell_pos = _to_ell(AT, np_, mp, k_width=ell_kt)

    # Symbolic analysis: C++ builder when available (native/mps_native.cpp,
    # the reference's build_normal_system role), Python fallback otherwise.
    from . import native as _native

    def _pattern_for(mat, pos, rows, cols, width, row_pad):
        if _native.available():
            pa, pb, pc, sid, slo, sup = _native.native_normal_pattern(
                mat.indptr, mat.indices, rows, cols, width, row_pad
            )
            return NormalPattern(pa, pb, pc, sid, slo, sup)
        return build_normal_pattern(mat, pos, row_pad)

    def _pad_pattern(pattern, p_size, s_size, dst_oob):
        if p_size is None and s_size is None:
            return pattern
        P0, S0 = pattern.pair_a.size, pattern.s_low.size
        Pp = p_size if p_size is not None else P0
        Sp = s_size if s_size is not None else S0
        if Pp < P0 or Sp < S0:
            raise ValueError("pattern pad sizes smaller than actual pattern")

        def padi(a, size, fill):
            out = np.full(size, fill, dtype=np.int32)
            out[: a.size] = a
            return out

        return NormalPattern(
            pair_a=padi(pattern.pair_a, Pp, 0),
            pair_b=padi(pattern.pair_b, Pp, 0),
            pair_col=padi(pattern.pair_col, Pp, 0),
            # out-of-range segment -> dropped by segment_sum
            seg_id=padi(pattern.seg_id, Pp, Sp),
            # out-of-bounds destination -> dropped by mode="drop"
            s_low=padi(pattern.s_low, Sp, dst_oob),
            s_up=padi(pattern.s_up, Sp, dst_oob),
        )

    _z = np.zeros(0, dtype=np.int32)
    empty = NormalPattern(_z, _z, _z, _z, _z, _z)

    pattern = empty
    if kkt in ("normal", "both"):
        pattern = _pattern_for(A, ell_pos, m, n, val.shape[1], mp)
        pattern = _pad_pattern(pattern, pattern_p, pattern_nnzs, mp * mp)

    cpattern = empty
    if kkt in ("condensed", "both"):
        # Pattern of A'A = normal pattern of A' (pair positions index the
        # flat AT ELL; pair_col = constraint row, gathering the live weight).
        cpattern = _pattern_for(AT, t_ell_pos, n, m, tval.shape[1], np_)
        cpattern = _pad_pattern(cpattern, cpattern_p, cpattern_nnzs, np_ * np_)

    # Quadratic term: full-symmetric ELL (qmatvec + condensed scatter-add).
    qval = qidx = None
    if qp.Q is not None:
        Qs = qp.Q.tocsr()
        Qs.sort_indices()
        Qs.sum_duplicates()
        Qs.eliminate_zeros()
        qval, qidx, _ = _to_ell(Qs, np_, np_, k_width=ell_kq)
    elif ell_kq is not None:
        # Explicit zero Q: lets an LP share a batched QP bucket (all
        # instances in a vmapped bucket must carry the same pytree shape).
        qval = np.zeros((np_, ell_kq), dtype=np.float64)
        qidx = np.zeros((np_, ell_kq), dtype=np.int32)

    def vecpad(v, size, fill=0.0):
        out = np.full(size, fill, dtype=np.float64)
        out[: v.shape[0]] = v
        return out

    row_mask = np.zeros(mp, dtype=bool)
    row_mask[:m] = True
    col_mask = np.zeros(np_, dtype=bool)
    col_mask[:n] = True

    # flat ELL index arrays reference [mp, K]; matvec gathers x over idx —
    # padded slots read x[0] with val 0: harmless.
    return SparseDeviceQP(
        c=jnp.asarray(vecpad(qp.c, np_), dtype=dtype),
        b=jnp.asarray(vecpad(qp.lcon, mp), dtype=dtype),
        lb=jnp.asarray(vecpad(qp.lvar, np_), dtype=dtype),
        ub=jnp.asarray(vecpad(qp.uvar, np_), dtype=dtype),
        c0=jnp.asarray(qp.c0, dtype=dtype),
        row_mask=jnp.asarray(row_mask),
        col_mask=jnp.asarray(col_mask),
        x0=jnp.asarray(vecpad(qp.x0, np_), dtype=dtype),
        y0=jnp.asarray(vecpad(qp.y0, mp), dtype=dtype),
        A_val=jnp.asarray(val, dtype=dtype),
        A_col=jnp.asarray(idx),
        AT_val=jnp.asarray(tval, dtype=dtype),
        AT_row=jnp.asarray(tidx),
        pair_a=jnp.asarray(pattern.pair_a),
        pair_b=jnp.asarray(pattern.pair_b),
        pair_col=jnp.asarray(pattern.pair_col),
        seg_id=jnp.asarray(pattern.seg_id),
        s_low=jnp.asarray(pattern.s_low),
        s_up=jnp.asarray(pattern.s_up),
        Q=None,
        Q_val=None if qval is None else jnp.asarray(qval, dtype=dtype),
        Q_col=None if qidx is None else jnp.asarray(qidx),
        cpair_a=jnp.asarray(cpattern.pair_a),
        cpair_b=jnp.asarray(cpattern.pair_b),
        cpair_col=jnp.asarray(cpattern.pair_col),
        cseg_id=jnp.asarray(cpattern.seg_id),
        c_low=jnp.asarray(cpattern.s_low),
        c_up=jnp.asarray(cpattern.s_up),
    )
