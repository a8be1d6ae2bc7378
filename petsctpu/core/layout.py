"""Row-partition layouts.

The device equivalent of the reference's PetscLayout (reference:
src/vec/vec/impls/mpi/pmap.c:130 PetscLayoutSetUp): a contiguous
row-range partition of a global axis over the shards of a 1-D device
mesh axis. Unlike MPI ranks, XLA sharding requires EQUAL shard sizes,
so layouts pad the global size up to a multiple of the shard count and
track the true (unpadded) size; padded rows are identity rows / zero
entries that never affect results.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Layout:
    """Contiguous equal-size row partition of [0, n) over `nshards` shards."""

    n: int             # true global size
    nshards: int       # number of shards (mesh axis size)

    @property
    def shard_size(self) -> int:
        return -(-self.n // self.nshards)  # ceil

    @property
    def n_padded(self) -> int:
        return self.shard_size * self.nshards

    @property
    def n_pad(self) -> int:
        return self.n_padded - self.n

    def owner(self, gidx) -> np.ndarray:
        """Shard owning each global index (vectorized)."""
        return np.asarray(gidx) // self.shard_size

    def range(self, shard: int) -> tuple:
        """[start, end) of global rows owned by `shard` (may overlap pad)."""
        s = self.shard_size
        return (shard * s, min((shard + 1) * s, self.n))

    def local_index(self, gidx) -> np.ndarray:
        return np.asarray(gidx) % self.shard_size

    def pad_vector(self, x: np.ndarray, fill=0.0) -> np.ndarray:
        """Pad a global host vector up to n_padded."""
        if self.n_pad == 0:
            return x
        pad_shape = (self.n_pad,) + x.shape[1:]
        return np.concatenate([x, np.full(pad_shape, fill, dtype=x.dtype)])

    def unpad_vector(self, x):
        return x[: self.n]
