"""Checkpoint / viewer I/O.

Reference: binary viewers (src/sys/classes/viewer/impls/binary/
binv.c:693 PetscViewerBinaryOpen; VecLoad_Binary vecio.c:41; MatLoad
matrix.c:924). Two on-disk formats:

  * native .npz — CSR triplets + metadata, the framework's own
    checkpoint format (deterministic layout so resumed solves continue
    identically);
  * the reference's big-endian PETSc binary format (classid-tagged:
    MAT 1211216, VEC 1211214) for direct interop with reference-
    generated matrices/vectors (the ex10 DATAFILESPATH workflow).
"""

from __future__ import annotations

import struct

import numpy as np
import scipy.sparse as sp

MAT_CLASSID = 1211216
VEC_CLASSID = 1211214


# ---------------------------------------------------------------------------
# native npz checkpoints
# ---------------------------------------------------------------------------
def save_vec(path: str, x) -> None:
    np.savez_compressed(path, kind="vec", data=np.asarray(x))


def load_vec(path: str) -> np.ndarray:
    z = np.load(path, allow_pickle=False)
    assert str(z["kind"]) == "vec", f"{path} is not a vec checkpoint"
    return z["data"]


def save_mat(path: str, A) -> None:
    A = sp.csr_matrix(A)
    np.savez_compressed(path, kind="mat", shape=np.asarray(A.shape),
                        indptr=A.indptr, indices=A.indices, data=A.data)


def load_mat(path: str) -> sp.csr_matrix:
    z = np.load(path, allow_pickle=False)
    assert str(z["kind"]) == "mat", f"{path} is not a mat checkpoint"
    return sp.csr_matrix((z["data"], z["indices"], z["indptr"]),
                         shape=tuple(z["shape"]))


def save_system(path: str, A, b=None, x=None) -> None:
    """ex10-style system checkpoint (matrix + optional rhs/solution)."""
    A = sp.csr_matrix(A)
    payload = dict(kind="system", shape=np.asarray(A.shape),
                   indptr=A.indptr, indices=A.indices, data=A.data)
    if b is not None:
        payload["b"] = np.asarray(b)
    if x is not None:
        payload["x"] = np.asarray(x)
    np.savez_compressed(path, **payload)


def load_system(path: str):
    z = np.load(path, allow_pickle=False)
    assert str(z["kind"]) == "system"
    A = sp.csr_matrix((z["data"], z["indices"], z["indptr"]),
                      shape=tuple(z["shape"]))
    b = z["b"] if "b" in z else None
    x = z["x"] if "x" in z else None
    return A, b, x


# ---------------------------------------------------------------------------
# PETSc binary format (big-endian), for reference interop
# ---------------------------------------------------------------------------
def petsc_binary_write_mat(path: str, A) -> None:
    """MatView binary layout: classid, m, n, nnz, rownnz[m],
    colidx[nnz] (int32 BE), values[nnz] (float64 BE)."""
    A = sp.csr_matrix(A)
    A.sort_indices()
    m, n = A.shape
    with open(path, "wb") as f:
        header = np.array([MAT_CLASSID, m, n, A.nnz], dtype=">i4")
        f.write(header.tobytes())
        f.write(np.diff(A.indptr).astype(">i4").tobytes())
        f.write(A.indices.astype(">i4").tobytes())
        f.write(A.data.astype(">f8").tobytes())


def petsc_binary_read_mat(path: str, complex_scalars=None) -> sp.csr_matrix:
    """complex_scalars: True for PETSC_USE_COMPLEX-written files (the
    scalar type is a build-time property of the writer, not encoded in
    the file — same as the reference's reader); None auto-detects from
    the file size."""
    with open(path, "rb") as f:
        classid, m, n, nnz = np.frombuffer(f.read(16), dtype=">i4")
        assert classid == MAT_CLASSID, f"not a PETSc Mat file ({classid})"
        rownnz = np.frombuffer(f.read(4 * m), dtype=">i4")
        indices = np.frombuffer(f.read(4 * nnz), dtype=">i4")
        payload = f.read()
    if complex_scalars is None:
        complex_scalars = len(payload) >= 16 * nnz
    if complex_scalars:
        data = np.frombuffer(payload[:16 * nnz], dtype=">c16") \
            .astype(np.complex128)
    else:
        data = np.frombuffer(payload[:8 * nnz], dtype=">f8") \
            .astype(np.float64)
    indptr = np.concatenate([[0], np.cumsum(rownnz)]).astype(np.int64)
    return sp.csr_matrix((data, indices.astype(np.int64), indptr),
                         shape=(m, n))


def petsc_binary_write_vec(path: str, x) -> None:
    x = np.asarray(x, dtype=np.float64)
    with open(path, "wb") as f:
        f.write(np.array([VEC_CLASSID, len(x)], dtype=">i4").tobytes())
        f.write(x.astype(">f8").tobytes())


def petsc_binary_read_vec(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        classid, n = np.frombuffer(f.read(8), dtype=">i4")
        assert classid == VEC_CLASSID, f"not a PETSc Vec file ({classid})"
        return np.frombuffer(f.read(8 * n), dtype=">f8").astype(np.float64)


def load_any_matrix(path: str):
    """Dispatch loader: .npz (native), .mtx/.mtx.gz (MatrixMarket),
    anything else: PETSc binary."""
    if path.endswith(".npz"):
        z = np.load(path, allow_pickle=False)
        if str(z["kind"]) == "system":
            return load_system(path)[0]
        return load_mat(path)
    if path.endswith((".mtx", ".mtx.gz")):
        from scipy.io import mmread
        return sp.csr_matrix(mmread(path))
    return petsc_binary_read_mat(path)


# ---------------------------------------------------------------------------
# HDF5 viewer (PetscViewerHDF5: src/sys/classes/viewer/impls/hdf5;
# VecView_HDF5 stores each object as a named dataset)
# ---------------------------------------------------------------------------
def hdf5_save_vec(path: str, name: str, x) -> None:
    """VecView to an HDF5 dataset (appends/overwrites in the file)."""
    import h5py

    with h5py.File(path, "a") as f:
        if name in f:
            del f[name]
        f.create_dataset(name, data=np.asarray(x))


def hdf5_load_vec(path: str, name: str) -> np.ndarray:
    """VecLoad from an HDF5 dataset."""
    import h5py

    with h5py.File(path, "r") as f:
        return np.asarray(f[name])


def hdf5_save_mat(path: str, name: str, A) -> None:
    """MatView: CSR triplet stored under a group (indptr/indices/data
    + shape attribute)."""
    import h5py

    A = sp.csr_matrix(A)
    with h5py.File(path, "a") as f:
        if name in f:
            del f[name]
        g = f.create_group(name)
        g.create_dataset("indptr", data=A.indptr)
        g.create_dataset("indices", data=A.indices)
        g.create_dataset("data", data=A.data)
        g.attrs["shape"] = A.shape


def hdf5_load_mat(path: str, name: str) -> sp.csr_matrix:
    import h5py

    with h5py.File(path, "r") as f:
        g = f[name]
        return sp.csr_matrix((np.asarray(g["data"]),
                              np.asarray(g["indices"]),
                              np.asarray(g["indptr"])),
                             shape=tuple(g.attrs["shape"]))


def pad_to_block_size(A: sp.csr_matrix, bs: int) -> sp.csr_matrix:
    """Pad a square matrix with unit-diagonal rows until the size is
    divisible by bs — exactly the reference's blocked-MatLoad padding
    (MatLoad_SeqBAIJ, src/mat/impls/baij/seq/baij.c:3530-3598:
    rowlength 1, column M+i, value 1.0)."""
    A = sp.csr_matrix(A)
    m, n = A.shape
    assert m == n, "blocked load: square matrices only (baij.c:3526)"
    extra = (-m) % bs
    if extra == 0:
        return A
    return sp.block_diag([A, sp.eye(extra)]).tocsr()


def petsc_binary_read_mat_baij(path: str, bs: int, dtype=None,
                               fmt: str = "ell"):
    """MatLoad for -mat_type baij from a reference binary file
    (MatLoad_SeqBAIJ baij.c:3497): the on-disk format is the scalar
    AIJ stream; the reader pads to a bs-divisible size and packs into
    bs-blocked storage. Returns (device BAIJ, padded scipy CSR)."""
    from petsctpu.mat.bsr import baij_from_scipy_bsr

    A = pad_to_block_size(petsc_binary_read_mat(path), bs)
    return baij_from_scipy_bsr(A, bs=bs, dtype=dtype, fmt=fmt), A


def petsc_binary_read_mat_sbaij(path: str, bs: int, dtype=None):
    """MatLoad for -mat_type sbaij (MatLoad_SeqSBAIJ,
    src/mat/impls/sbaij/seq/sbaij.c — same scalar stream, upper
    block-triangle kept). Returns (device SBAIJ, padded scipy CSR of
    the FULL symmetric matrix)."""
    from petsctpu.mat.sbaij import sbaij_from_scipy

    A = pad_to_block_size(petsc_binary_read_mat(path), bs)
    return sbaij_from_scipy(A, bs=bs, dtype=dtype), A


def petsc_binary_read_system(path: str):
    """Read matrix + rhs from ONE file (the ex10 same-file layout:
    MatLoad then VecLoad from the same viewer, ex10.c:129). Returns
    (scipy CSR, rhs ndarray)."""
    with open(path, "rb") as f:
        classid, m, n, nnz = np.frombuffer(f.read(16), dtype=">i4")
        assert classid == MAT_CLASSID, f"not a PETSc Mat file ({classid})"
        rownnz = np.frombuffer(f.read(4 * m), dtype=">i4")
        indices = np.frombuffer(f.read(4 * nnz), dtype=">i4")
        data = np.frombuffer(f.read(8 * nnz), dtype=">f8") \
            .astype(np.float64)
        indptr = np.concatenate([[0], np.cumsum(rownnz)]).astype(np.int64)
        A = sp.csr_matrix((data, indices.astype(np.int64), indptr),
                          shape=(m, n))
        vclass, vn = np.frombuffer(f.read(8), dtype=">i4")
        assert vclass == VEC_CLASSID, "no rhs vector after the matrix"
        b = np.frombuffer(f.read(8 * vn), dtype=">f8").astype(np.float64)
    return A, b
