"""Element-per-ciphertext encrypted matrices.

Counterpart of ``hetpu/linalg/matrix.py`` (the reference's
``he::linalg::Matrix``, ``he_linalg.h:47-168``, ``he_linalg.cpp:10-384``),
on the session's device: the m×n elements are ONE batched ciphertext
``[m·n, parts, L, N]``, so elementwise ops are one batched call and matmul
is a gather + batched multiply + tree reduction + ONE batched finish
(relinearize + rescale for CKKS, relinearize for BFV).

Works over either scheme through the session's ``mat_*`` protocol
(:class:`~hetpu_torch.session.Session`, :class:`~hetpu_torch.bfv.BfvSession`).
The lazy transpose is a flag and an index remap (reference ``transp()``
``he_linalg.cpp:35-38``, ``ij_to_idx`` ``:376-384``); leading-axis gathers
use index tensors on the ciphertext's device.  Each element's ciphertext
may itself be slot-batched (the reference's batch_matmul demos).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.ciphertext import Ciphertext
from ..session import Session
from .batched import _tree_mod_add


def _index(idx, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.int64, device=like.device)


@dataclass
class Matrix:
    sess: Session
    ct: Ciphertext                  # [m*n, parts, L, N]
    rows: int
    cols: int
    transposed: bool = False

    # -- construction --------------------------------------------------
    @classmethod
    def encrypt(cls, sess: Session, mat, level=None, scale=None) -> "Matrix":
        """mat: [m, n] scalars, or [m, n, b]: a slot-batch of b independent
        matrices (the reference's batch_matmul demos)."""
        mat = np.asarray(mat)
        m, n = mat.shape[:2]
        elems = [sess.encrypt(mat[i, j], level, scale).data
                 for i in range(m) for j in range(n)]
        base = sess.encrypt(0.0, level, scale)
        return cls(sess, base.with_(data=torch.stack(elems)), rows=m, cols=n)

    def get_dims(self):
        return (self.cols, self.rows) if self.transposed else (self.rows,
                                                               self.cols)

    def _idx(self, i: int, j: int) -> int:
        """Logical (i,j) → storage index, honouring the lazy transpose
        (reference ``ij_to_idx`` he_linalg.cpp:376-379)."""
        if self.transposed:
            i, j = j, i
        return i * self.cols + j

    def transp(self) -> "Matrix":
        return Matrix(self.sess, self.ct, self.rows, self.cols,
                      not self.transposed)

    def _decrypt_elems(self, take, out: np.ndarray) -> np.ndarray:
        m, n = self.get_dims()
        for i in range(m):
            for j in range(n):
                d = self.ct.data[self._idx(i, j)]
                out[i, j] = take(self.sess.decrypt(self.ct.with_(data=d)))
        return out

    def decrypt(self, slot: int = 0) -> np.ndarray:
        m, n = self.get_dims()
        return self._decrypt_elems(lambda v: v[slot],
                                   np.zeros((m, n), dtype=np.complex128))

    def decrypt_exact(self, batch: int = 1) -> np.ndarray:
        """Exact integer decrypt (BFV sessions): [m, n] object ints, or
        [m, n, batch] when each element is slot-batched."""
        m, n = self.get_dims()
        out = self._decrypt_elems(lambda v: v[:batch],
                                  np.zeros((m, n, batch), dtype=object))
        return out[..., 0] if batch == 1 else out

    def decrypt_batch(self, batch: int) -> np.ndarray:
        """[m, n, batch]: all slot-batched instances."""
        m, n = self.get_dims()
        return self._decrypt_elems(lambda v: v[:batch],
                                   np.zeros((m, n, batch), dtype=np.complex128))

    # -- elementwise (reference he_linalg.cpp:68-197) ------------------
    def _aligned(self, other: "Matrix"):
        if self.get_dims() != other.get_dims():
            raise ValueError("dim mismatch")
        return self.sess.align(self.ct, other.ct)

    def _data_logical(self, ct: Ciphertext):
        """Data gathered into logical (row-major, untransposed) order."""
        if not self.transposed:
            return ct.data
        m, n = self.get_dims()
        perm = [self._idx(i, j) for i in range(m) for j in range(n)]
        return ct.data[_index(perm, ct.data)]

    def _elementwise(self, other: "Matrix", op) -> "Matrix":
        a, b = self._aligned(other)
        m, n = self.get_dims()
        out = op(a.with_(data=self._data_logical(a)),
                 b.with_(data=other._data_logical(b)))
        return Matrix(self.sess, out, m, n)

    def __add__(self, other: "Matrix"):
        return self._elementwise(other, self.sess.ev.add)

    def __sub__(self, other: "Matrix"):
        return self._elementwise(other, self.sess.ev.sub)

    def __neg__(self):
        return Matrix(self.sess, self.sess.ev.negate(self.ct), self.rows,
                      self.cols, self.transposed)

    def hadamard(self, other: "Matrix"):
        return self._elementwise(other, self.sess.mat_mult_finish)

    # -- matmul (reference he_linalg.cpp:202-236: naive O(mnp) inner
    #    products; here one batched multiply + tree reduce + one finish) --
    def matmul(self, other: "Matrix") -> "Matrix":
        sess = self.sess
        m, n = self.get_dims()
        n2, p = other.get_dims()
        if n != n2:
            raise ValueError(f"matmul inner dim: {n} vs {n2}")
        a, b = sess.align(self.ct, other.ct)
        # gather indices: A[i,k] repeated over j; B[k,j] repeated over i
        ia = [self._idx(i, k)
              for i in range(m) for j in range(p) for k in range(n)]
        ib = [other._idx(k, j)
              for i in range(m) for j in range(p) for k in range(n)]
        prod = sess.mat_multiply(a.with_(data=a.data[_index(ia, a.data)]),
                                 b.with_(data=b.data[_index(ib, b.data)]))
        # reduce over k: [m*p, n, 3, L, N] summed on axis 1
        d = prod.data.reshape(m * p, n, *prod.data.shape[1:])
        q = sess.ctx.mont(prod.level)["q"]
        acc = _tree_mod_add([d[:, k] for k in range(n)], q)
        out = sess.mat_reduce_finish(prod.with_(data=acc))
        return Matrix(sess, out, m, p)

    def left_matmul_with_transp(self) -> "Matrix":
        """AᵀA without materialising the transpose (reference
        ``he_linalg.cpp:241-273``)."""
        return self.transp().matmul(self)

    def matmul_square(self) -> "Matrix":
        """A·A (reference ``he_linalg.cpp:278-311``)."""
        m, n = self.get_dims()
        if m != n:
            raise ValueError("matmul_square needs a square matrix")
        return self.matmul(self)

    def matmul_pow(self, exponent: int) -> "Matrix":
        """A^k by binary square-and-multiply (reference
        ``he_linalg.cpp:316-349``)."""
        if exponent < 1:
            raise ValueError("exponent must be >= 1")
        m, n = self.get_dims()
        if m != n:
            raise ValueError("matmul_pow needs a square matrix")
        result = None
        base = self
        e = exponent
        while e:
            if e & 1:
                result = base if result is None else result.matmul(base)
            e >>= 1
            if e:
                base = base.matmul_square()
        return result
