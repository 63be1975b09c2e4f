"""Slot-packed encrypted vectors and matrices.

Counterpart of ``hetpu/linalg/batched.py`` (the reference's
``he::linalg::BatchedVector`` / ``BatchedMatrix``, ``he_linalg.h:172-412``,
``he_linalg.cpp:388-1006``), on the session's device:

* a BatchedVector is ONE ciphertext whose CKKS slots hold the vector;
* a BatchedMatrix is ONE batched ciphertext ``[d, parts, L, N]``: the
  reference's ``vector<BatchedVector>`` becomes a leading tensor axis, so
  every elementwise op is one batched call over the whole matrix;
* the diagonal-method matmul (``he_linalg.cpp:943-1006``) uses HOISTED
  rotations: the key-switch digit decomposition is computed once per
  input and reused across all rotation steps, which come one at a time
  (``Evaluator.rotate_hoisted_iter``); each step's product is added into
  one running sum as it comes (span ``hetpu/mm.accumulate``), so the
  loop holds one step's rotation and product, not d of each;
* products stay 3-part until one batched relinearize + rescale per output.

Layouts (square d×d, one bvec per leading index):
  col  — bvec j, slot i  =  M[i, j]
  diag — bvec j, slot i  =  M[i, (i+j) mod d]

With a mesh active on the session (``Session.use_mesh``), the diag×col
matvec routes through ``parallel.bucketed_matvec``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..core import galois
from ..core.ciphertext import Ciphertext
from ..core.modular import mod_add
from ..session import Session
from ..utils.profiling import span


def _has_step_keys(sess: Session, steps) -> bool:
    """True iff a galois key exists for every rotation step (hoisting needs
    the exact key; the doubling fallback only needs the ±2^i chain)."""
    n = sess.ctx.params.poly_degree
    return sess.gk is not None and all(
        s % (n // 2) == 0 or sess.gk.has(galois.rotation_elt(n, s))
        for s in steps)


def _tree_mod_add(parts, q):
    """Balanced modular reduction of a list of equally-shaped tensors."""
    xs = list(parts)
    while len(xs) > 1:
        nxt = [mod_add(xs[i], xs[i + 1], q) for i in range(0, len(xs) - 1, 2)]
        if len(xs) % 2:
            nxt.append(xs[-1])
        xs = nxt
    return xs[0]


# ======================================================================
# BatchedVector
# ======================================================================

@dataclass
class BatchedVector:
    """dim values in the slots of one ciphertext (reference
    ``he_linalg.h:172``)."""

    sess: Session
    ct: Ciphertext
    dim: int

    # -- construction --------------------------------------------------
    @classmethod
    def encrypt(cls, sess: Session, values, level=None, scale=None):
        v = np.asarray(values)
        return cls(sess, sess.encrypt(v, level, scale), dim=v.shape[0])

    def decrypt(self) -> np.ndarray:
        return self.sess.decrypt(self.ct)[: self.dim]

    def _wrap(self, ct: Ciphertext, dim=None) -> "BatchedVector":
        return BatchedVector(self.sess, ct, self.dim if dim is None else dim)

    # -- elementwise ops (reference he_linalg.cpp:411-505) -------------
    def __add__(self, other):
        s, ev = self.sess, self.sess.ev
        if isinstance(other, BatchedVector):
            a, b = s.align(self.ct, other.ct)
            return self._wrap(ev.add(a, b))
        return self._wrap(ev.add_plain(self.ct, s.const_like(self.ct, other)))

    def __sub__(self, other):
        s, ev = self.sess, self.sess.ev
        if isinstance(other, BatchedVector):
            a, b = s.align(self.ct, other.ct)
            return self._wrap(ev.sub(a, b))
        return self._wrap(ev.sub_plain(self.ct, s.const_like(self.ct, other)))

    def __neg__(self):
        return self._wrap(self.sess.ev.negate(self.ct))

    def __mul__(self, other):
        """Fused multiply + relin + rescale (reference
        ``mult_relin_rescale`` he_linalg.cpp:556-584)."""
        s, ev = self.sess, self.sess.ev
        if isinstance(other, BatchedVector):
            a, b = s.align(self.ct, other.ct)
            return self._wrap(ev.multiply_relin_rescale(a, b, s.rk))
        pt = s.encode(other, level=self.ct.level)
        return self._wrap(ev.rescale(ev.multiply_plain(self.ct, pt)))

    __radd__ = __add__
    __rmul__ = __mul__

    def square(self) -> "BatchedVector":
        return self._wrap(self.sess.ev.square_relin_rescale(self.ct,
                                                            self.sess.rk))

    # -- rotations (reference he_linalg.cpp:589-638) -------------------
    def rotate(self, steps: int) -> "BatchedVector":
        """Slots left by `steps` (negative → right)."""
        return self._wrap(self.sess.ev.rotate(self.ct, steps, self.sess.gk))

    def __lshift__(self, steps: int):
        return self.rotate(steps)

    def __rshift__(self, steps: int):
        return self.rotate(-steps)

    # -- reductions ----------------------------------------------------
    _HOIST_DIM = 32   # below this, one hoisted decompose covers all steps

    def sum_elems(self) -> "BatchedVector":
        """Rotate-and-add reduction; the total lands in slot 0.  Non-power-
        of-2 dims go by bitwise block decomposition (reference
        ``he_linalg.cpp:667-713``; slots ≠ 0 hold partial sums, ``mask``
        isolates slot 0).

        For dim ≤ 32 with a key for every step, the sum is Σ_{j<dim}
        rot(ct, j) with ONE hoisted digit decomposition.  Larger dims hoist
        the block-window rotations together, then run a log-depth doubling
        chain per power-of-2 block."""
        ev, gk = self.sess.ev, self.sess.gk
        dim = self.dim
        if dim == 1:
            return self._wrap(self.ct, dim=1)
        q = self.sess.ctx.mont(self.ct.level)["q"]
        if dim <= self._HOIST_DIM and _has_step_keys(self.sess, range(1, dim)):
            rots = ev.rotate_hoisted(self.ct, list(range(dim)), gk)
            acc = _tree_mod_add([r.data for r in rots], q)
            return self._wrap(self.ct.with_(data=acc), dim=1)
        windows, blocks = [], []
        w = 0
        for b in reversed(range(dim.bit_length())):
            if (dim >> b) & 1:
                windows.append(w)
                blocks.append(b)
                w += 1 << b
        starts = ev.rotate_hoisted(self.ct, windows, gk)
        acc = None
        for b, block in zip(blocks, starts):
            for i in reversed(range(b)):
                block = ev.add(block, ev.rotate(block, 1 << i, gk))
            acc = block if acc is None else ev.add(acc, block)
        return self._wrap(acc, dim=1)

    def mask(self, keep_slots) -> "BatchedVector":
        """Multiply by a 0/1 indicator (consumes one level): isolates
        slots, e.g. after sum_elems.  Indicator plaintexts are cached per
        (slots, level)."""
        keep = tuple(int(i) for i in np.atleast_1d(np.asarray(keep_slots)))

        def build():
            m = np.zeros(self.sess.slots)
            m[list(keep)] = 1.0
            return m

        pt = self.sess.cached_encode(("mask", keep), build,
                                     level=self.ct.level)
        return self._wrap(self.sess.ev.rescale(
            self.sess.ev.multiply_plain(self.ct, pt)))

    def replicate_slot0(self, out_dim: int) -> "BatchedVector":
        """Broadcast slot 0's value to slots [0, out_dim): mask, then
        rotate and accumulate.  Small out_dims use one hoisted decompose
        for all the right-rotations."""
        v = self.mask([0])
        ev, gk = self.sess.ev, self.sess.gk
        ct = v.ct
        if out_dim <= self._HOIST_DIM and _has_step_keys(
                self.sess, (-j for j in range(1, out_dim))):
            q = self.sess.ctx.mont(ct.level)["q"]
            rots = ev.rotate_hoisted(ct, [-j for j in range(out_dim)], gk)
            return self._wrap(
                ct.with_(data=_tree_mod_add([r.data for r in rots], q)),
                dim=out_dim)
        span = 1
        while span < out_dim:
            ct = ev.add(ct, ev.rotate(ct, -span, gk))
            span *= 2
        return self._wrap(ct, dim=out_dim)


# ======================================================================
# BatchedMatrix
# ======================================================================

@dataclass
class BatchedMatrix:
    """Matrix as a batched ciphertext with a layout tag and a LAZY
    transpose flag (reference ``he_linalg.h:307-412``).

    Stored orientation (ignoring the flag): ``rows × cols``; the data
    carries ``cols`` bvecs of dim ``rows`` in col layout (one per leading
    index), or ``rows`` generalized diagonals in diag layout (square
    only).  ``transposed=True`` reads the SAME ciphertexts as the
    transpose, moving nothing (reference ``he_linalg.cpp:742-755``).
    """

    sess: Session
    ct: Ciphertext                 # data [nbvec, parts, L, N]
    rows: int                      # stored row count (bvec dim)
    cols: int                      # stored col count
    layout: str = "col"            # "col" | "diag"
    transposed: bool = False

    @property
    def row_dim(self) -> int:
        return self.cols if self.transposed else self.rows

    @property
    def col_dim(self) -> int:
        return self.rows if self.transposed else self.cols

    def transp(self) -> "BatchedMatrix":
        """Lazy transpose: flip the flag, move nothing."""
        return replace(self, transposed=not self.transposed)

    @classmethod
    def encrypt(cls, sess: Session, mat: np.ndarray, layout: str = "col",
                level=None, scale=None) -> "BatchedMatrix":
        mat = np.asarray(mat, dtype=np.complex128)
        r, c = mat.shape
        if layout == "diag" and r != c:
            raise ValueError("diag layout requires a square matrix")
        nb = c if layout == "col" else r
        bvecs = []
        for j in range(nb):
            vec = mat[:, j] if layout == "col" else \
                np.array([mat[i, (i + j) % c] for i in range(r)])
            # tile twice so that slot rotations wrap mod the bvec dim (the
            # Halevi-Shoup replication trick)
            if 2 * vec.shape[0] <= sess.slots:
                vec = np.tile(vec, 2)
            bvecs.append(sess.encrypt(vec, level, scale).data)
        base = sess.encrypt(np.zeros(r), level, scale)
        return cls(sess, base.with_(data=torch.stack(bvecs)), rows=r, cols=c,
                   layout=layout)

    def decrypt(self) -> np.ndarray:
        r, c = self.rows, self.cols
        out = np.zeros((r, c), dtype=np.complex128)
        for j in range(self.ct.data.shape[0]):
            vals = self.sess.decrypt(self.ct.with_(data=self.ct.data[j]))[:r]
            if self.layout == "col":
                out[:, j] = vals
            else:
                for i in range(r):
                    out[i, (i + j) % c] = vals[i]
        return out.T if self.transposed else out

    def _wrap(self, ct, layout, rows=None, cols=None) -> "BatchedMatrix":
        return BatchedMatrix(self.sess, ct,
                             self.rows if rows is None else rows,
                             self.cols if cols is None else cols, layout)

    def _check_elemwise(self, other: "BatchedMatrix"):
        if (self.layout != other.layout
                or self.transposed != other.transposed
                or (self.rows, self.cols) != (other.rows, other.cols)):
            raise ValueError("elementwise ops need matching layout/"
                             "orientation/dims")

    # -- elementwise (one batched call over the bvec axis) -------------
    def __add__(self, other: "BatchedMatrix"):
        self._check_elemwise(other)
        a, b = self.sess.align(self.ct, other.ct)
        return replace(self, ct=self.sess.ev.add(a, b))

    def __sub__(self, other: "BatchedMatrix"):
        self._check_elemwise(other)
        a, b = self.sess.align(self.ct, other.ct)
        return replace(self, ct=self.sess.ev.sub(a, b))

    def __neg__(self):
        return replace(self, ct=self.sess.ev.negate(self.ct))

    def hadamard(self, other: "BatchedMatrix"):
        self._check_elemwise(other)
        a, b = self.sess.align(self.ct, other.ct)
        return replace(self, ct=self.sess.ev.multiply_relin_rescale(
            a, b, self.sess.rk))

    def square_elems(self):
        return replace(self, ct=self.sess.ev.square_relin_rescale(
            self.ct, self.sess.rk))

    # -- the rotation matmul (reference he_linalg.cpp:943-1006) --------
    def matmul(self, other: "BatchedMatrix") -> "BatchedMatrix":
        """Reference-parity dispatch (``he_linalg.cpp:943-973``): self must
        not be transposed; other must be col layout.

        * self diag (square d×d), other col NOT transposed (d×p, p bvecs):
          C[:,i] = Σ_k diag_k(A) ⊙ rot(B[:,i], k) → col layout d×p.
        * self col (m×n), other col TRANSPOSED (A·Bᵀ without moving B):
          out_diag_i = Σ_j col_j(A) ⊙ rot(col_j(B), i) → diag layout."""
        if self.transposed:
            raise ValueError("matmul: left operand must not be transposed "
                             "(reference he_linalg.cpp:947)")
        if other.layout != "col":
            raise ValueError("matmul: right operand must be col layout")
        if self.layout == "diag":
            if other.transposed:
                raise ValueError("diag×col needs other NOT transposed")
            return self._matmul_diag_col(other)
        if not other.transposed:
            raise ValueError("col×col needs other TRANSPOSED "
                             "(A·Bᵀ path, reference he_linalg.cpp:964)")
        return self.matmul_cols_t(replace(other, transposed=False))

    def _matmul_diag_col(self, other: "BatchedMatrix") -> "BatchedMatrix":
        """One hoisted decomposition of B's whole batch serves all d
        rotation steps; each step's product is added into one 3-part sum
        in place (``multiply_acc``: diag_k(A) read by every column
        uncopied), relinearized and rescaled once."""
        sess, ev = self.sess, self.sess.ev
        if other.rows != self.cols:
            raise ValueError(f"inner dim {self.cols} vs {other.rows}")
        a, b = sess.align(self.ct, other.ct)
        d, p = self.rows, other.cols
        if sess.mesh is not None and self._mesh_routable(sess.mesh, d, p):
            # the rotation loop bucketed over the mesh: rotation buckets
            # and their galois keys per rank, one modular all-reduce
            from .. import parallel
            out = parallel.bucketed_matvec(
                sess, a, b.with_(data=b.data[0]), d, sess.mesh,
                sess.mesh_axis)
            return self._wrap(out.with_(data=out.data[None]), "col",
                              rows=d, cols=1)
        acc, k = None, 0
        # batched over B's columns; step k's rotation meets diag_k(A) as it
        # comes, so one rotation lives at a time beside the sum (no
        # enumerate: its kept tuple would hold the last rotation)
        for rot in ev.rotate_hoisted_iter(b, range(d), sess.gk):
            with span("mm.accumulate"):
                acc = ev.multiply_acc(acc, rot, a.with_(data=a.data[k]))
            del rot
            k += 1
        out = ev.rescale(ev.relinearize(acc, sess.rk))
        return self._wrap(out, "col", rows=d, cols=p)

    def _mesh_routable(self, mesh, d: int, p: int) -> bool:
        """bucketed_matvec covers the matvec: one column, a rotation count
        divisible by the mesh axis, galois keys for every step 0..d−1
        (step 0: the identity element's self key switch)."""
        sess = self.sess
        axis = sess.mesh_axis
        if axis not in mesh.shape or p != 1 or d % mesh.shape[axis]:
            return False
        n = sess.ctx.params.poly_degree
        return all(sess.gk.has(galois.rotation_elt(n, s)) for s in range(d))

    def matmul_cols_t(self, other: "BatchedMatrix") -> "BatchedMatrix":
        """col×col → A·Bᵀ in diag layout (the reference's col×colᵀ path):
        out_diag_i = Σ_j col_j(A) ⊙ rot(col_j(B), i).  Square only."""
        sess, ev = self.sess, self.sess.ev
        if self.layout != "col" or other.layout != "col":
            raise ValueError("matmul_cols_t needs both operands in col layout")
        if self.cols != other.cols:
            raise ValueError(f"inner dim {self.cols} vs {other.cols}")
        if self.rows != other.rows or self.rows != self.cols:
            raise ValueError("col×colᵀ output is diag layout: square only")
        a, b = sess.align(self.ct, other.ct)
        d = self.rows
        q = sess.ctx.mont(a.level)["q"]
        outs = []
        for rot in ev.rotate_hoisted_iter(b, range(d), sess.gk):  # [d]-batched
            with span("mm.accumulate"):
                prod3 = ev.multiply(rot, a)                   # [d, 3, L, N]
                outs.append(_tree_mod_add(
                    [prod3.data[j] for j in range(d)], q))
            del rot, prod3
        c3 = Ciphertext(data=torch.stack(outs), level=a.level,
                        scale=a.scale * b.scale)
        out = ev.rescale(ev.relinearize(c3, sess.rk))
        return self._wrap(out, "diag")
