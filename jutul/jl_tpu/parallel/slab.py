"""Slab domain decomposition over a device mesh.

JAX-native counterpart of the reference's MPI domain decomposition
(reference: src/dd/ submodels/subdomains with ghost overlap,
ext/JutulPartitionedArraysExt — per-rank submodel + PVector halo
consistency). Where the reference builds per-rank submodel objects and
exchanges ghosts through PartitionedArrays/MPI (interface.jl:189-220,
krylov.jl:54,86), here the SAME local problem template is instantiated once
and executed SPMD under ``jax.shard_map``; halo exchange is a
``lax.ppermute`` of boundary planes over the device mesh, and global reductions
are ``lax.psum`` (SURVEY.md §2.8 / §5 mapping).

Decomposition: the global Cartesian mesh is cut into D contiguous slabs
along its slowest (last) axis. Every shard's local problem is the *extended
slab*: [halo-prev plane | owned planes | halo-next plane]. Because every
shard has identical local shape and topology, one CompiledModel describes
all shards; per-shard differences (dead boundary faces of the first/last
shard, parameter values) enter as data: transmissibilities of dead faces are
zero, which annihilates both flux and Jacobian contributions.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..meshes.cartesian import CartesianMesh


@dataclass
class SlabDecomposition:
    """Static decomposition data for an (nx, ny, nz) mesh over D devices."""

    global_dims: tuple
    n_devices: int
    planes_per_shard: int  # owned planes per shard
    plane_size: int  # nx * ny
    local_mesh: CartesianMesh  # the extended slab template
    n_own: int
    n_ext: int
    own_slice: slice  # owned cells inside the extended local numbering

    # masks/values stacked over the shard axis (D, ...)
    face_alive: np.ndarray  # (D, nf_loc) 1.0 where the local face is real
    own_mask: np.ndarray  # (D, n_ext) 1 on owned cells

    @property
    def nf_local(self) -> int:
        return self.local_mesh.number_of_faces()


def decompose_slabs(mesh: CartesianMesh, n_devices: int) -> SlabDecomposition:
    dims = mesh._dims3()
    nx, ny, nz = dims
    if nz % n_devices != 0:
        raise ValueError(
            f"nz={nz} must be divisible by n_devices={n_devices} "
            "(pad the mesh)"
        )
    if any(not np.isscalar(d) for d in mesh._deltas):
        # variable deltas per slab would break shard homogeneity along z;
        # x/y vectors are fine
        pass
    ppl = nz // n_devices
    plane = nx * ny
    # extended local mesh: ppl + 2 halo planes; deltas: reuse x/y, uniform z
    deltas = mesh.deltas()
    dz = deltas[2] if len(deltas) > 2 else np.array([1.0])
    dz0 = float(dz[0])
    local_mesh = CartesianMesh(
        (nx, ny, ppl + 2),
        (np.asarray(deltas[0]), np.asarray(deltas[1] if len(deltas) > 1
                                           else [1.0]), dz0 * (ppl + 2)),
    )
    n_ext = plane * (ppl + 2)
    n_own = plane * ppl
    own_slice = slice(plane, plane + n_own)

    # face liveness per shard: faces touching halo planes are dead when the
    # halo does not exist (shard 0 lower halo, shard D-1 upper halo), and
    # faces BETWEEN two halo cells never exist. Fluxes across the owned/halo
    # interface are alive (that's the DD coupling).
    nb = local_mesh.neighborship()  # (nf_loc, 2) local cells
    kz = nb // plane  # plane index of each cell (z-major ordering, i-fastest)
    D = n_devices
    face_alive = np.ones((D, nb.shape[0]))
    lower_halo = (kz == 0)
    upper_halo = (kz == ppl + 1)
    touches_lower = lower_halo.any(axis=1)
    touches_upper = upper_halo.any(axis=1)
    face_alive[0, touches_lower] = 0.0
    face_alive[D - 1, touches_upper] = 0.0
    # faces connecting two halo cells (possible only if ppl == 0) are dead
    both_halo = (lower_halo.all(axis=1)) | (upper_halo.all(axis=1))
    face_alive[:, both_halo] = 0.0

    own_mask = np.zeros((D, n_ext))
    own_mask[:, own_slice] = 1.0

    return SlabDecomposition(
        global_dims=dims,
        n_devices=D,
        planes_per_shard=ppl,
        plane_size=plane,
        local_mesh=local_mesh,
        n_own=n_own,
        n_ext=n_ext,
        own_slice=own_slice,
        face_alive=face_alive,
        own_mask=own_mask,
    )


def shard_cell_array(dec: SlabDecomposition, arr: np.ndarray) -> np.ndarray:
    """Global (n_cells, ...) -> (D * n_own, ...) == identity for slab order.

    With lexicographic (i-fastest) global ordering and slab cuts on z, the
    global array is already shard-contiguous; this is a shape check only.
    """
    n_glob = int(np.prod(dec.global_dims))
    assert arr.shape[0] == n_glob, (arr.shape, n_glob)
    return arr


def local_to_global_cells(dec: SlabDecomposition, shard: int) -> np.ndarray:
    """(n_ext,) global cell index per local cell; -1 for nonexistent halos."""
    nx, ny, nz = dec.global_dims
    plane = dec.plane_size
    kz_base = shard * dec.planes_per_shard - 1
    lc = np.arange(dec.n_ext)
    gplane = kz_base + lc // plane
    valid = (gplane >= 0) & (gplane < nz)
    return np.where(valid, gplane * plane + lc % plane, -1)


def local_face_values(dec: SlabDecomposition, shard: int,
                      global_faces: np.ndarray, global_mesh: CartesianMesh,
                      fill: float = 0.0) -> np.ndarray:
    """Map a global per-face array to the shard's local face ordering.

    Local faces that have no global counterpart (dead halo-side faces) get
    ``fill``. Used to build per-shard transmissibility / gdz arrays.
    """
    gdims = dec.global_dims
    nx, ny, nz = gdims
    plane = dec.plane_size
    ppl = dec.planes_per_shard
    lmesh = dec.local_mesh
    nb_l = lmesh.neighborship()
    out = np.full(nb_l.shape[0], fill, dtype=np.float64)

    # map local cell -> global cell (halo planes wrap to neighbor shards)
    kz_base = shard * ppl - 1  # global plane of local plane 0
    lc = np.arange(dec.n_ext)
    lplane = lc // plane
    inplane = lc % plane
    gplane = kz_base + lplane
    valid = (gplane >= 0) & (gplane < nz)
    gcell = np.where(valid, gplane * plane + inplane, -1)

    gl = gcell[nb_l[:, 0]]
    gr = gcell[nb_l[:, 1]]
    ok = (gl >= 0) & (gr >= 0)
    # find the global face index for each (gl, gr) pair via lookup
    gnb = global_mesh.neighborship()
    n_glob = nx * ny * nz
    key = gnb[:, 0].astype(np.int64) * n_glob + gnb[:, 1]
    order = np.argsort(key)
    key_sorted = key[order]
    q = gl[ok].astype(np.int64) * n_glob + gr[ok]
    pos = np.searchsorted(key_sorted, q)
    assert np.all(key_sorted[pos] == q), "face lookup failed"
    out[ok] = global_faces[order[pos]]
    return out
