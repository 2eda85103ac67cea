"""Small dense factorizations on the host, as the reference's LAPACK
calls compute them.

The decompositions (PCA, SVD, GLRM's SVD init) reduce the (rows, P)
matrix on the model's device to a P x P Gram or a (P, k) sketch, then
factor that small matrix.  ``jnp.linalg.eigh`` and ``jnp.linalg.qr`` on
the CPU are LAPACK's float32 ``ssyevd`` (lower triangle) and
``sgeqrf``/``sorgqr``; scipy's ``eigh(driver="evd", lower=True)`` and
``qr(mode="economic")`` call the same routines on the same float32
input and return the same bits, eigenvector signs included.
``torch.linalg.eigh`` and ``numpy.linalg.eigh`` choose other signs for
some columns, and GLRM's projection of its SVD init onto NonNegative or
L1 sets is not sign-symmetric, so the signs are kept as LAPACK's
``evd`` gives them and never canonicalized.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _host32(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype=np.float32)


def eigh_desc(G) -> Tuple[np.ndarray, np.ndarray]:
    """(eigenvalues, eigenvectors) of the symmetric float32 matrix ``G``
    (a tensor on any device or an array), largest first, the values
    clamped at 0 (``pca.py:88-91``, ``svd.py:216-218``): float32 host
    arrays."""
    from scipy.linalg import eigh
    evals, evecs = eigh(_host32(G), driver="evd", lower=True)
    order = np.argsort(-evals, kind="stable")
    return (np.maximum(evals[order], np.float32(0.0)).astype(np.float32),
            np.ascontiguousarray(evecs[:, order], dtype=np.float32))


def qr_q(Y) -> np.ndarray:
    """The economic Q factor of the float32 (P, k) matrix ``Y``, as a
    float32 host array."""
    from scipy.linalg import qr
    q, _ = qr(_host32(Y), mode="economic")
    return np.ascontiguousarray(q, dtype=np.float32)
