"""Matrix Market (.mtx) operator IO — the framework's data loader.

The reference has NO file IO at all: every operator is assembled in user
code (triplets_matrix.hpp:139-178 append/setFromDenseMatrix).  Real
workloads load operators from the standard sparse interchange format, so
this module provides it: a fast single-pass native parser
(``native/src/builders.cpp`` ``mm_read``, plain C ABI via ctypes) feeding
straight into :class:`~eigenex_tpu.sparse.coo.COOMatrix` device arrays,
with symmetry expansion done vectorized on host and a scipy.io fallback
when the native library is unavailable or the file uses the dense
``array`` format.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..utils.exceptions import EigenexError
from .coo import COOMatrix

__all__ = ["load_matrix_market", "save_matrix_market"]


def _expand_symmetry(rows, cols, vals, symmetry: str):
    """Mirror the stored lower triangle per the MM symmetry tag.

    A loader's job is to refuse bad data: the MM spec forbids stored
    diagonal entries in skew-symmetric files (they would have to equal
    their own negation), so their presence is a malformed file, not
    something to pass through unmirrored."""
    if symmetry == "general":
        return rows, cols, vals
    off = rows != cols
    if symmetry == "symmetric":
        mirr = vals[off]
    elif symmetry == "skew-symmetric":
        if not np.all(off):
            n_diag = int(np.sum(~off))
            raise EigenexError(
                f"malformed skew-symmetric MatrixMarket file: {n_diag} stored "
                "diagonal entr" + ("y" if n_diag == 1 else "ies")
                + " (the format forbids them; a_ii = -a_ii forces zero)"
            )
        mirr = -vals[off]
    elif symmetry == "hermitian":
        mirr = np.conj(vals[off])
    else:  # pragma: no cover - native layer validates
        raise EigenexError(f"unknown MatrixMarket symmetry {symmetry!r}")
    rows2 = np.concatenate([rows, cols[off]])
    cols2 = np.concatenate([cols, rows[off]])
    vals2 = np.concatenate([vals, mirr])
    return rows2, cols2, vals2


def load_matrix_market(path, *, dtype=None, expand_symmetry: bool = True) -> COOMatrix:
    """Load a Matrix Market file as a :class:`COOMatrix`.

    Coordinate files in all four fields (real/integer/complex/pattern) and
    all four symmetries are handled; symmetric/skew/hermitian storage is
    expanded to full COO (``expand_symmetry=False`` keeps the stored
    triangle, e.g. to build a half-traffic
    :class:`~eigenex_tpu.sparse.sym_bsr.SymBSRMatrix` instead).  ``dtype``
    overrides the natural dtype (f64, or c128 for complex fields).

    Reader selection is BY MEASUREMENT: scipy's bundled
    ``fast_matrix_market`` C++ reader parses a 2M-nnz file ~4x faster
    than our single-pass native parser, so scipy is primary and the
    native ctypes parser (``native/src/builders.cpp``) serves when scipy
    is unavailable — and always for ``expand_symmetry=False``, which
    needs the RAW stored triangle that ``scipy.io.mmread`` does not
    expose (it auto-expands symmetry).
    """
    from ..native import native_available

    def _native_read(path, allow_dense_fallback=True):
        from ..native import mm_read

        try:
            return mm_read(path)
        except RuntimeError as e:
            if "not a coordinate" in str(e):
                if allow_dense_fallback:
                    return _scipy_mm_read(path)
                # the caller asked for the RAW stored triangle; the scipy
                # dense reader would auto-expand symmetry and report
                # "general" — a silent contract violation, so refuse
                raise EigenexError(
                    "expand_symmetry=False requires a coordinate-format "
                    f"MatrixMarket file; {path!r} uses the dense 'array' "
                    "format (no stored triangle to preserve)"
                ) from e
            raise EigenexError(str(e)) from e

    if not expand_symmetry:
        if not native_available():
            raise EigenexError(
                "expand_symmetry=False needs the native parser (raw stored "
                "triangle); the native library is unavailable on this host"
            )
        rows, cols, vals, shape, symmetry = _native_read(path, allow_dense_fallback=False)
    else:
        try:
            rows, cols, vals, shape, symmetry = _scipy_mm_read(path)
        except (ImportError, EigenexError):
            if not native_available():
                raise
            rows, cols, vals, shape, symmetry = _native_read(path)
    if expand_symmetry:
        rows, cols, vals = _expand_symmetry(rows, cols, vals, symmetry)
    if dtype is None:
        dtype = np.complex128 if np.iscomplexobj(vals) else np.float64
    return COOMatrix(
        jnp.asarray(rows, jnp.int32),
        jnp.asarray(cols, jnp.int32),
        jnp.asarray(vals, dtype),
        (int(shape[0]), int(shape[1])),
    )


def _scipy_mm_read(path):
    """Fallback parser (also covers the dense 'array' format)."""
    import scipy.io

    try:
        info = scipy.io.mminfo(path)
        m = scipy.io.mmread(path)
    except Exception as e:
        raise EigenexError(f"cannot parse MatrixMarket file {path!r}: {e}") from e
    if hasattr(m, "tocoo"):
        c = m.tocoo()
        # scipy expands symmetry itself but does NOT validate skew files;
        # a valid skew-symmetric file stores no diagonal, so any diagonal
        # entry surviving expansion marks a malformed file (the expansion
        # only mirrors off-diagonal entries)
        if str(info[5]) == "skew-symmetric" and np.any(c.row == c.col):
            raise EigenexError(
                "malformed skew-symmetric MatrixMarket file: stored "
                "diagonal entries (the format forbids them; a_ii = -a_ii "
                "forces zero)"
            )
        # report general to skip re-expansion
        return (
            c.row.astype(np.int64),
            c.col.astype(np.int64),
            np.asarray(c.data),
            c.shape,
            "general",
        )
    dense = np.asarray(m)
    rows, cols = np.nonzero(dense)
    return rows.astype(np.int64), cols.astype(np.int64), dense[rows, cols], dense.shape, "general"


def _check_mirror_consistency(rows, cols, vals, shape, symmetry, tol):
    """Verify the dropped upper triangle is implied by the stored lower
    one: every (r, c>r, v) entry must have a stored twin (c, r) whose
    value mirrors per the symmetry tag (within ``tol`` relative), the
    diagonal must satisfy the tag's constraint (real for hermitian,
    absent/zero for skew-symmetric), and no upper entry may lack a twin.
    Raises :class:`EigenexError` on any violation — writing a
    non-symmetric operator with a symmetry tag would silently corrupt it
    on round-trip otherwise."""
    n = shape[1]
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key, vv = key[order], vals[order]
    if key.size and np.any(key[1:] == key[:-1]):
        raise EigenexError(
            "symmetric-tagged save requires merged (duplicate-free) "
            "triplets; run the builder's shrink/merge first"
        )
    upper = rows < cols
    diag = rows == cols
    scale = float(np.abs(vals).max()) if vals.size else 1.0
    atol = tol * max(scale, 1.0)
    if symmetry == "skew-symmetric":
        if np.any(np.abs(vals[diag]) > atol):
            raise EigenexError(
                "operator has nonzero diagonal entries; skew-symmetric "
                "MatrixMarket storage forbids them (a_ii = -a_ii)"
            )
    elif symmetry == "hermitian" and np.iscomplexobj(vals):
        if np.any(np.abs(vals[diag].imag) > atol):
            raise EigenexError(
                "operator diagonal is not real; cannot store as hermitian"
            )
    if not np.any(upper):
        return
    mirror_key = cols[upper] * n + rows[upper]
    pos = np.searchsorted(key, mirror_key)
    pos_c = np.clip(pos, 0, max(key.size - 1, 0))
    found = key[pos_c] == mirror_key
    if not np.all(found):
        r_bad, c_bad = rows[upper][~found][0], cols[upper][~found][0]
        raise EigenexError(
            f"entry ({r_bad},{c_bad}) above the diagonal has no stored "
            f"mirror twin ({c_bad},{r_bad}); the operator is not "
            f"{symmetry} — refusing to drop it"
        )
    twin = vv[pos_c]
    if symmetry == "symmetric":
        expect = twin
    elif symmetry == "skew-symmetric":
        expect = -twin
    else:  # hermitian
        expect = np.conj(twin)
    bad = np.abs(vals[upper] - expect) > atol
    if np.any(bad):
        r_bad, c_bad = rows[upper][bad][0], cols[upper][bad][0]
        raise EigenexError(
            f"entry ({r_bad},{c_bad}) does not mirror its twin "
            f"({c_bad},{r_bad}) under {symmetry!r}; the operator is not "
            f"{symmetry} — refusing the lossy save"
        )


def save_matrix_market(
    path,
    A,
    *,
    symmetry: str = "general",
    comment: str | None = None,
    check_tol: float = 1e-12,
) -> None:
    """Write a :class:`COOMatrix` (or anything with row/col/val/shape) as a
    coordinate Matrix Market file.

    ``symmetry="symmetric"``/``"hermitian"``/``"skew-symmetric"`` stores
    only the lower triangle; the dropped upper entries are first verified
    to equal their stored twins' mirror within ``check_tol`` (relative to
    max |v|), and the save raises :class:`EigenexError` if the operator
    does not actually have the claimed symmetry.  Skew-symmetric storage
    additionally omits the (necessarily zero) diagonal, per the MM spec.

    The body is written in vectorized chunks (NumPy per-column formatting
    + joined writes), not a per-entry Python loop — a 10^8-nnz operator
    saves in minutes, not hours.
    """
    rows = np.asarray(A.row, np.int64)
    cols = np.asarray(A.col, np.int64)
    vals = np.asarray(A.val)
    shape = A.shape
    field = "complex" if np.iscomplexobj(vals) else "real"
    if symmetry not in ("general", "symmetric", "skew-symmetric", "hermitian"):
        raise EigenexError(f"unknown symmetry {symmetry!r}")
    if symmetry != "general":
        if shape[0] != shape[1]:
            raise EigenexError("symmetric storage requires a square operator")
        _check_mirror_consistency(rows, cols, vals, shape, symmetry, check_tol)
        keep = (rows > cols) if symmetry == "skew-symmetric" else (rows >= cols)
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        if comment:
            for line in str(comment).splitlines():
                f.write(f"% {line}\n")
        f.write(f"{shape[0]} {shape[1]} {len(vals)}\n")
        CHUNK = 1 << 20
        for lo in range(0, len(vals), CHUNK):
            hi = min(lo + CHUNK, len(vals))
            r_s = (rows[lo:hi] + 1).astype("U")
            c_s = (cols[lo:hi] + 1).astype("U")
            if field == "complex":
                v_re = np.char.mod("%.17g", vals[lo:hi].real)
                v_im = np.char.mod("%.17g", vals[lo:hi].imag)
                body = r_s + " " + c_s + " " + v_re + " " + v_im
            else:
                v_s = np.char.mod("%.17g", vals[lo:hi])
                body = r_s + " " + c_s + " " + v_s
            f.write("\n".join(body.tolist()))
            f.write("\n")
