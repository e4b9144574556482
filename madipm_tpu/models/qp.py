"""Problem data model.

Host-side general LP/QP container (``QuadraticModel``) and the device-side
padded standard-form pytree (``DeviceQP``) consumed by the jitted solver.

Capability match with the reference's problem layer:
- ``QuadraticModel`` plays the role of QuadraticModels.jl's ``QuadraticModel``
  ingested by ``MPCSolver`` (reference: src/structure.jl:79-178, README.md:50-60).
- ``standard_form`` reproduces the semantics of ``standard_form_qp``
  (reference: src/utils.jl:345-505): slacks for inequality rows, ranged upper
  bounds moved into extra equality rows ``x + w = xu``, fixed variables kept.
- ``DeviceQP`` replaces the CUDA device model (reference:
  ext/MadIPMCUDAExt/MadIPMCUDAExt.jl:122-137) with a dense representation:
  padded arrays + boolean masks instead of index views.

The reference keeps data sparse (CSR + cuDSS); here the device format is
dense and padded to aligned shapes, so assembly and matvecs are matmuls
instead of gather-heavy sparse pointer chasing.  Sparse inputs stay sparse on host
(scipy.sparse) until the final packing step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

INF = float("inf")


def _as_csr(a, m, n) -> sp.csr_matrix:
    if a is None:
        return sp.csr_matrix((m, n))
    if sp.issparse(a):
        return a.tocsr().astype(np.float64)
    return sp.csr_matrix(np.asarray(a, dtype=np.float64).reshape(m, n))


@dataclasses.dataclass
class QuadraticModel:
    """General-form convex QP (host side, float64, scipy.sparse).

    min  c0 + c'x + 1/2 x' Q x
    s.t. lcon <= A x <= ucon
         lvar <= x <= uvar

    ``Q`` is stored as the full symmetric matrix (the reference stores the
    lower triangle, ext/MadIPMMathOptInterfaceExt/parse_moi.jl:120-160; we
    symmetrize on ingestion).
    """

    c: np.ndarray
    A: sp.csr_matrix
    lcon: np.ndarray
    ucon: np.ndarray
    lvar: np.ndarray
    uvar: np.ndarray
    Q: Optional[sp.csr_matrix] = None
    c0: float = 0.0
    x0: Optional[np.ndarray] = None
    y0: Optional[np.ndarray] = None
    name: str = "qp"
    minimize: bool = True

    def __post_init__(self):
        self.c = np.asarray(self.c, dtype=np.float64).ravel()
        n = self.c.shape[0]
        self.lvar = np.asarray(self.lvar, dtype=np.float64).ravel()
        self.uvar = np.asarray(self.uvar, dtype=np.float64).ravel()
        self.lcon = np.asarray(self.lcon, dtype=np.float64).ravel()
        self.ucon = np.asarray(self.ucon, dtype=np.float64).ravel()
        m = self.lcon.shape[0]
        self.A = _as_csr(self.A, m, n)
        assert self.A.shape == (m, n), (self.A.shape, m, n)
        if self.Q is not None and self.Q.nnz == 0:
            self.Q = None
        if self.Q is not None:
            Q = _as_csr(self.Q, n, n)
            # Symmetrize: accept lower-triangular or full input.
            QT = Q.T.tocsr()
            D = sp.diags(Q.diagonal())
            if abs(Q - QT).sum() > 1e-12 * max(1.0, abs(Q).sum()):
                Q = Q + QT - D
            self.Q = Q.tocsr()
        if self.x0 is None:
            self.x0 = np.zeros(n)
        else:
            self.x0 = np.asarray(self.x0, dtype=np.float64).ravel()
        if self.y0 is None:
            self.y0 = np.zeros(m)
        else:
            self.y0 = np.asarray(self.y0, dtype=np.float64).ravel()

    # ------------------------------------------------------------------
    @property
    def nvar(self) -> int:
        return self.c.shape[0]

    @property
    def ncon(self) -> int:
        return self.lcon.shape[0]

    @property
    def nnzj(self) -> int:
        return self.A.nnz

    @property
    def nnzh(self) -> int:
        return 0 if self.Q is None else sp.tril(self.Q).nnz

    @property
    def is_qp(self) -> bool:
        return self.Q is not None

    def obj(self, x: np.ndarray) -> float:
        v = self.c0 + self.c @ x
        if self.Q is not None:
            v += 0.5 * x @ (self.Q @ x)
        return float(v)

    def cons(self, x: np.ndarray) -> np.ndarray:
        return self.A @ x

    def grad(self, x: np.ndarray) -> np.ndarray:
        g = self.c.copy()
        if self.Q is not None:
            g = g + self.Q @ x
        return g


def from_dense(c, A, lcon, ucon, lvar, uvar, Q=None, **kw) -> QuadraticModel:
    """Convenience constructor from dense arrays."""
    A = sp.csr_matrix(np.atleast_2d(np.asarray(A, dtype=np.float64)))
    if Q is not None:
        Q = sp.csr_matrix(np.asarray(Q, dtype=np.float64))
    return QuadraticModel(c=c, A=A, lcon=lcon, ucon=ucon, lvar=lvar, uvar=uvar, Q=Q, **kw)


# ---------------------------------------------------------------------------
# Standard-form reformulation (reference: src/utils.jl:345-505)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StandardFormMap:
    """Undo record for :func:`standard_form` (primal AND dual maps).

    Dual semantics (stationarity ``c + Qx + A'y - zl + zu = 0``, reference
    src/kernels.jl:403-430):

    - original rows keep their dual: row i's x-coefficients are unchanged,
      so ``y_orig[i] = y_std[i]`` (the slack bookkeeping ``-y_i - zl_s +
      zu_s = 0`` is internal);
    - a variable upper bound moved into extra row ``x_j + w = xu`` (dual
      ``y_e``) re-enters x_j's stationarity exactly where ``+zu_j`` used
      to: ``zu_orig[j] = y_std[m + k]`` (>= 0 at optimality via
      ``y_e = zl_w``);
    - moved SLACK upper bounds need nothing: the row dual already carries
      them.
    """

    n: int  # original variable count
    m: int  # original row count
    ind_ineq: np.ndarray  # inequality rows that got slacks
    ind_rng: np.ndarray  # range-bounded entries of [x; s] with moved ub

    def duals(self, y_std, zl_std, zu_std):
        y = np.asarray(y_std)[: self.m].copy()
        zl = np.asarray(zl_std)[: self.n].copy()
        zu = np.asarray(zu_std)[: self.n].copy()
        for k, idx in enumerate(self.ind_rng):
            if idx < self.n:  # variable (not slack) upper bound moved
                zu[idx] = max(float(np.asarray(y_std)[self.m + k]), 0.0)
        return y, zl, zu

    def x(self, x_std):
        return np.asarray(x_std)[: self.n]


def standard_form(qp: QuadraticModel, return_map: bool = False):
    """Reformulate a general QP into standard form.

    Matches ``standard_form_qp`` (reference src/utils.jl:345-505):

    - slack variables ``s`` with ``A x - s = 0`` for every inequality row
      (``lcon < ucon``), the row bounds moving onto ``s``;
    - every range-bounded variable or slack (finite lower *and* upper bound,
      not fixed) gets its upper bound rewritten as an extra equality row
      ``x + w = xu`` with a fresh nonnegative variable ``w``;
    - equality rows and fixed variables are preserved as-is.

    The result has only equality constraints and one-sided (or fixed) bounds,
    which is the form the NORMAL KKT path requires.
    """
    n, m = qp.nvar, qp.ncon
    lvar, uvar, lcon, ucon = qp.lvar, qp.uvar, qp.lcon, qp.ucon

    ind_ineq = np.flatnonzero(lcon < ucon)
    ns = ind_ineq.size

    # Range-bounded entries among [x; s] (reference loops src/utils.jl:390-416)
    ind_rng: list[int] = []
    xu_vals: list[float] = []
    for i in range(n):
        if lvar[i] == uvar[i]:
            continue  # fixed variable: keep as-is
        if -INF < lvar[i] < uvar[i] < INF:
            ind_rng.append(i)
            xu_vals.append(uvar[i])
    for k, i in enumerate(ind_ineq):
        if -INF < lcon[i] < ucon[i] < INF:
            ind_rng.append(n + k)
            xu_vals.append(ucon[i])
    ind_rng = np.asarray(ind_rng, dtype=np.int64)
    xu_vals = np.asarray(xu_vals, dtype=np.float64)
    nw = ind_rng.size

    nvar = n + ns + nw
    ncon = m + nw

    # Assemble the new Jacobian in COO.
    Ai, Aj = qp.A.tocoo().row, qp.A.tocoo().col
    Ax = qp.A.tocoo().data
    Bi = np.concatenate([ind_ineq, np.repeat(np.arange(m, m + nw), 2)])
    Bj_rng = np.empty(2 * nw, dtype=np.int64)
    Bj_rng[0::2] = ind_rng
    Bj_rng[1::2] = n + ns + np.arange(nw)
    Bj = np.concatenate([n + np.arange(ns), Bj_rng])
    Bx = np.concatenate([-np.ones(ns), np.ones(2 * nw)])
    A_new = sp.csr_matrix(
        (
            np.concatenate([Ax, Bx]),
            (np.concatenate([Ai, Bi]), np.concatenate([Aj, Bj])),
        ),
        shape=(ncon, nvar),
    )

    # Constraint bounds: inequality rows become `A x - s = 0`; extra rows pin
    # the moved upper bound.
    lcon_new = np.zeros(ncon)
    ucon_new = np.zeros(ncon)
    eq_mask = lcon == ucon
    lcon_new[:m] = np.where(eq_mask, lcon, 0.0)
    ucon_new[:m] = np.where(eq_mask, ucon, 0.0)
    lcon_new[m:] = xu_vals
    ucon_new[m:] = xu_vals

    lvar_new = np.concatenate([lvar, lcon[ind_ineq], np.zeros(nw)])
    uvar_new = np.concatenate([uvar, ucon[ind_ineq], np.full(nw, INF)])
    # Upper bounds of range-bounded entries moved into the new equality rows.
    uvar_new[ind_rng] = INF
    fixed = np.flatnonzero(lvar == uvar)
    uvar_new[fixed] = uvar[fixed]

    Q_new = None
    if qp.Q is not None:
        Q_new = sp.bmat(
            [[qp.Q, None], [None, sp.csr_matrix((ns + nw, ns + nw))]], format="csr"
        )

    out = QuadraticModel(
        c=np.concatenate([qp.c, np.zeros(ns + nw)]),
        A=A_new,
        lcon=lcon_new,
        ucon=ucon_new,
        lvar=lvar_new,
        uvar=uvar_new,
        Q=Q_new,
        c0=qp.c0,
        x0=np.concatenate([qp.x0, np.zeros(ns + nw)]),
        y0=np.concatenate([qp.y0, np.zeros(nw)]),
        name=qp.name,
        minimize=qp.minimize,
    )
    if return_map:
        return out, StandardFormMap(n=n, m=m, ind_ineq=ind_ineq, ind_rng=ind_rng)
    return out


# ---------------------------------------------------------------------------
# Slack-augmented internal form (MadNLP-style, handles remaining inequalities)
# ---------------------------------------------------------------------------


def slack_form(qp: QuadraticModel) -> QuadraticModel:
    """Add slacks so every constraint is an equality: ``A x - s = 0``.

    This is the internal reformulation MadNLP applies via
    ``get_index_constraints``/``PrimalVector`` ([x; s] layout, reference:
    src/structure.jl:97-135): the solver itself only ever sees equality
    constraints plus bound constraints.  Unlike :func:`standard_form`, range
    bounds are kept two-sided.
    """
    m, n = qp.ncon, qp.nvar
    ind_ineq = np.flatnonzero(qp.lcon < qp.ucon)
    ns = ind_ineq.size
    if ns == 0:
        return qp
    S = sp.csr_matrix(
        (-np.ones(ns), (ind_ineq, np.arange(ns))),
        shape=(m, ns),
    )
    A_new = sp.hstack([qp.A, S], format="csr")
    eq = qp.lcon == qp.ucon
    b = np.where(eq, qp.lcon, 0.0)
    Q_new = None
    if qp.Q is not None:
        Q_new = sp.bmat([[qp.Q, None], [None, sp.csr_matrix((ns, ns))]], format="csr")
    s0 = np.clip(qp.A @ qp.x0, qp.lcon, qp.ucon)[ind_ineq]
    return QuadraticModel(
        c=np.concatenate([qp.c, np.zeros(ns)]),
        A=A_new,
        lcon=b,
        ucon=b,
        lvar=np.concatenate([qp.lvar, qp.lcon[ind_ineq]]),
        uvar=np.concatenate([qp.uvar, qp.ucon[ind_ineq]]),
        Q=Q_new,
        c0=qp.c0,
        x0=np.concatenate([qp.x0, s0]),
        y0=qp.y0,
        name=qp.name,
        minimize=qp.minimize,
    )


# ---------------------------------------------------------------------------
# Device pytree
# ---------------------------------------------------------------------------


def _round_up(x: int, mult: int) -> int:
    return max(mult, ((x + mult - 1) // mult) * mult)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceQP:
    """Padded, dense, device-resident standard-form QP.

    All constraints are equalities ``A x = b``; general bounds ``lb <= x <= ub``
    with +-inf for absent bounds.  Shapes are padded to multiples of
    ``pad_multiple``; ``row_mask``/``col_mask`` flag the live rows/columns.  Fixed
    variables (lb == ub) are pinned: they keep their value, contribute to
    ``A x`` and the objective, but are excluded from the KKT system — the
    masked analogue of MadNLP's ``MakeParameter`` treatment
    (reference: src/utils.jl:83, SURVEY §2.4).
    """

    c: jax.Array  # [n]
    A: jax.Array  # [m, n] dense
    b: jax.Array  # [m]
    lb: jax.Array  # [n], -inf where absent
    ub: jax.Array  # [n], +inf where absent
    Q: Optional[jax.Array]  # [n, n] dense or None for LP
    c0: jax.Array  # scalar
    row_mask: jax.Array  # [m] bool: live constraint rows
    col_mask: jax.Array  # [n] bool: live variables
    x0: jax.Array  # [n]
    y0: jax.Array  # [m]
    #: Ozaki bf16 slicings of A, A' and Q (ops/ozaki.py) — present only
    #: when the solver enabled Ozaki-evaluated fp64 matvecs; built AFTER
    #: row/objective scaling (driver.initialize), since they snapshot the
    #: matrix values.
    A_sl: Optional[object] = None
    At_sl: Optional[object] = None
    Q_sl: Optional[object] = None

    @property
    def n(self) -> int:
        return self.c.shape[-1]

    @property
    def m(self) -> int:
        return self.b.shape[-1]

    @property
    def is_qp(self) -> bool:
        return self.Q is not None

    # Derived masks (cheap, computed on the fly inside jit) ------------
    @property
    def free_mask(self) -> jax.Array:
        """Live, non-fixed variables: the columns the KKT system sees."""
        return self.col_mask & (self.lb < self.ub)

    @property
    def has_lb(self) -> jax.Array:
        return self.free_mask & jnp.isfinite(self.lb)

    @property
    def has_ub(self) -> jax.Array:
        return self.free_mask & jnp.isfinite(self.ub)

    # Jacobian operator interface -------------------------------------
    # The solver/KKT layers consume A only through these methods, so the
    # block-sparse representation (models/sparse.py) can swap in — the
    # analogue of the reference's MadIPMOperator SpMV abstraction
    # (ext/MadIPMCUDAExt/cuda_wrapper.jl:43-94).
    @property
    def dtype(self):
        return self.c.dtype

    @property
    def dense_A(self) -> jax.Array:
        """Dense Jacobian (AUGMENTED/K2 assembly needs it; the sparse
        representation raises here, like the reference's NormalKKTSystem
        erroring on nnzh>0, src/KKT/normalkkt.jl:40-43)."""
        return self.A

    def matvec(self, x) -> jax.Array:
        """A @ x (Ozaki-sliced when enabled and x is fp64)."""
        if self.A_sl is not None and x.dtype == jnp.float64:
            from ..ops import ozaki

            return ozaki.apply(self.A_sl, x)
        return jnp.dot(self.A, x, preferred_element_type=x.dtype)

    def rmatvec(self, y) -> jax.Array:
        """A' @ y (Ozaki-sliced when enabled and y is fp64).  With shared
        slices (At_sl is None but A_sl present), the transpose runs as the
        m-chunked contraction over the FORWARD slices (ozaki.matvec_t) —
        no transposed slice copy in device memory."""
        if y.dtype == jnp.float64:
            from ..ops import ozaki

            if self.At_sl is not None:
                return ozaki.apply(self.At_sl, y)
            if self.A_sl is not None:
                return ozaki.apply_t(self.A_sl, y)
        return jnp.dot(self.A.T, y, preferred_element_type=y.dtype)

    def with_ozaki(self, variant: str = "bf16", share_slices: bool = False,
                   n_slices=None) -> "DeviceQP":
        """Return a copy carrying Ozaki slicings of A (and A') (ops/ozaki.py).

        ``variant``: "bf16" (7 bf16 slices, fp32 accumulation) or "i8"
        (8 int8 slices, int32 accumulation — see ops/ozaki.py notes).
        ``share_slices=True`` stores only the forward slices and evaluates
        A'-matvecs via the transposed chunked contraction (ozaki.matvec_t)
        — halves the slice device-memory footprint.

        Must be called AFTER any row/column scaling of A (the slices
        snapshot values).  Requires lane-padded shapes (pad_to_device's
        128-multiples); returns self unchanged otherwise.
        """
        from ..ops import ozaki

        m, n = self.A.shape
        if m % ozaki.CHUNK or n % ozaki.CHUNK:
            return self
        return dataclasses.replace(
            self,
            A_sl=ozaki.slice_any(self.A, variant, n_slices),
            At_sl=None if share_slices
            else ozaki.slice_any(self.A.T, variant, n_slices),
            Q_sl=None if self.Q is None
            else ozaki.slice_any(self.Q, variant, n_slices),
        )

    def row_inf_norm(self) -> jax.Array:
        """max_j |A_ij| per row (set_scaling!, reference src/solver.jl:148-159)."""
        return jnp.max(jnp.abs(self.A), axis=1)

    def scale_rows(self, con_scale) -> "DeviceQP":
        """Return a copy with rows of A scaled (b is scaled by the caller).

        Any Ozaki slices are dropped: they snapshot A's values and must be
        rebuilt after scaling (driver.initialize does)."""
        return dataclasses.replace(
            self, A=self.A * con_scale[:, None], A_sl=None, At_sl=None
        )

    def assemble_normal_matrix(self, dinv, factor_dtype) -> jax.Array:
        """S = A diag(dinv) A' in the factor dtype (no regularization or
        diagonal pinning — the KKT layer applies those uniformly).

        One matmul: (m,n) * (n,) -> (m,n) @ (n,m) (the dense replacement
        for the reference's sparse row-intersection assembly,
        src/utils.jl:276-308 / ext/MadIPMCUDAExt/cuda_wrapper.jl:108-144).
        """
        Af = self.A.astype(factor_dtype)
        df = dinv.astype(factor_dtype)
        return jnp.dot(Af * df[None, :], Af.T, preferred_element_type=factor_dtype)

    # Quadratic-term operator interface --------------------------------
    # (so the KKT/solver layers never touch ``Q`` directly and the
    # ELL-sparse representation can swap in, models/sparse.py)
    def qmatvec(self, x) -> jax.Array:
        """Q @ x (zeros for an LP; Ozaki bf16-sliced when enabled)."""
        if self.Q is None:
            return jnp.zeros_like(x)
        if self.Q_sl is not None and x.dtype == jnp.float64:
            from ..ops import ozaki

            return ozaki.apply(self.Q_sl, x)
        return jnp.dot(self.Q, x, preferred_element_type=x.dtype)

    def scale_quad(self, obj_scale) -> "DeviceQP":
        """Return a copy with Q scaled by the objective scaling (drops any
        Ozaki slices of Q; driver.initialize rebuilds them after scaling)."""
        if self.Q is None:
            return self
        return dataclasses.replace(self, Q=self.Q * obj_scale, Q_sl=None)

    def live_rows(self) -> jax.Array:
        """Rows that touch at least one free column (structurally empty
        rows carry dy = 0; see ops/kkt._assemble_normal)."""
        A_eff = self.A * self.free_mask[None, :]
        return self.row_mask & (jnp.sum(A_eff * A_eff, axis=1) > 0)

    def assemble_ata(self, w, factor_dtype) -> jax.Array:
        """A' diag(w) A over free columns in the factor dtype (the K1
        condensed assembly's matmul; weights = live-row indicator)."""
        Af = (self.A * self.free_mask[None, :]).astype(factor_dtype)
        Aw = Af * w.astype(factor_dtype)[:, None]
        return jnp.dot(Aw.T, Af, preferred_element_type=factor_dtype)

    def add_quad(self, C, factor_dtype) -> jax.Array:
        """C + Q masked to free columns (no-op for an LP)."""
        if self.Q is None:
            return C
        free = self.free_mask
        return C + (self.Q * free[None, :] * free[:, None]).astype(factor_dtype)


def pad_to_device(
    qp: QuadraticModel,
    dtype=jnp.float64,
    pad_multiple: int = 128,
    m_pad: Optional[int] = None,
    n_pad: Optional[int] = None,
) -> DeviceQP:
    """Pack a host standard/slack-form model into a padded DeviceQP.

    The model must have only equality constraints (call :func:`slack_form` or
    :func:`standard_form` first).  Padded columns are pinned (lb=ub=0, masked
    out); padded rows get ``0 x = 0`` and are masked out of every reduction,
    with the KKT assembly pinning their diagonal so factorizations stay
    nonsingular.
    """
    if np.any(qp.lcon != qp.ucon):
        raise ValueError("pad_to_device requires equality-only constraints; run slack_form first")
    m, n = qp.ncon, qp.nvar
    mp = m_pad if m_pad is not None else _round_up(m, pad_multiple)
    np_ = n_pad if n_pad is not None else _round_up(n, pad_multiple)
    if mp < m or np_ < n:
        raise ValueError("padded shape smaller than problem")

    A = np.zeros((mp, np_), dtype=np.float64)
    A[:m, :n] = qp.A.toarray()
    c = np.zeros(np_)
    c[:n] = qp.c
    b = np.zeros(mp)
    b[:m] = qp.lcon
    lb = np.zeros(np_)
    ub = np.zeros(np_)
    lb[:n] = qp.lvar
    ub[:n] = qp.uvar
    x0 = np.zeros(np_)
    x0[:n] = qp.x0
    y0 = np.zeros(mp)
    y0[:m] = qp.y0
    row_mask = np.zeros(mp, dtype=bool)
    row_mask[:m] = True
    col_mask = np.zeros(np_, dtype=bool)
    col_mask[:n] = True

    Q = None
    if qp.Q is not None:
        Q = np.zeros((np_, np_), dtype=np.float64)
        Q[:n, :n] = qp.Q.toarray()
        Q = jnp.asarray(Q, dtype=dtype)

    return DeviceQP(
        c=jnp.asarray(c, dtype=dtype),
        A=jnp.asarray(A, dtype=dtype),
        b=jnp.asarray(b, dtype=dtype),
        lb=jnp.asarray(lb, dtype=dtype),
        ub=jnp.asarray(ub, dtype=dtype),
        Q=Q,
        c0=jnp.asarray(qp.c0, dtype=dtype),
        row_mask=jnp.asarray(row_mask),
        col_mask=jnp.asarray(col_mask),
        x0=jnp.asarray(x0, dtype=dtype),
        y0=jnp.asarray(y0, dtype=dtype),
    )
