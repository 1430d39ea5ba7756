"""Two-point flux approximation (TPFA) geometry products.

Counterpart of Jutul's finite-volume discretization helpers (reference:
src/discretization/finite-volume.jl — ``compute_half_face_trans`` :3-155,
``compute_face_trans`` :157-200, ``compute_boundary_trans`` :220-255,
``compute_face_gdz`` :290-313; permeability tensor expansion ``expand_perm``)
and the half-face maps (src/domains.jl:101-159).

All computation here is static model-build work: numpy in, numpy out. The
results (face transmissibilities, gravity gdz, half-face index maps) become
parameters / static index arrays of the jitted compute path.

Permeability input conventions (matching the reference):
- scalar per cell: ``(n,)`` isotropic
- diagonal tensor: ``(n, d)``
- symmetric full tensor (Voigt order): 2D ``(n, 3)`` = (Kxx, Kxy, Kyy);
  3D ``(n, 6)`` = (Kxx, Kxy, Kxz, Kyy, Kyz, Kzz)
"""

from __future__ import annotations

import numpy as np

from ..meshes.geometry import TwoPointFiniteVolumeGeometry


def expand_perm(perm: np.ndarray, dim: int) -> np.ndarray:
    """Expand permeability to full (n, d, d) tensors."""
    perm = np.asarray(perm, dtype=np.float64)
    n = perm.shape[0]
    if perm.ndim == 3:  # already full (n, d, d) tensors
        if perm.shape[1:] != (dim, dim):
            raise ValueError(
                f"Cannot interpret permeability of shape {perm.shape} "
                f"in {dim}D")
        return perm
    K = np.zeros((n, dim, dim))
    if perm.ndim == 1:
        for d in range(dim):
            K[:, d, d] = perm
        return K
    m = perm.shape[1]
    if m == dim:  # diagonal
        for d in range(dim):
            K[:, d, d] = perm[:, d]
        return K
    if dim == 2 and m == 3:
        K[:, 0, 0] = perm[:, 0]
        K[:, 0, 1] = K[:, 1, 0] = perm[:, 1]
        K[:, 1, 1] = perm[:, 2]
        return K
    if dim == 3 and m == 6:
        K[:, 0, 0] = perm[:, 0]
        K[:, 0, 1] = K[:, 1, 0] = perm[:, 1]
        K[:, 0, 2] = K[:, 2, 0] = perm[:, 2]
        K[:, 1, 1] = perm[:, 3]
        K[:, 1, 2] = K[:, 2, 1] = perm[:, 4]
        K[:, 2, 2] = perm[:, 5]
        return K
    raise ValueError(f"Cannot interpret permeability of shape {perm.shape} in {dim}D")


def _half_trans(cells, centroids, face_centroids, normals, areas, K,
                sgn: float = 1.0) -> np.ndarray:
    """T_hf = A * (K_c d) . (sgn * n) / |d|^2 with d = x_face - x_cell.

    Matches the reference half-face transmissibility formula
    (finite-volume.jl:130-155, half_face_trans :220): the normal is oriented
    outward from the cell via ``sgn`` (+1 for the left/first neighbor, -1 for
    the right/second), and the signed value is kept — on non-K-orthogonal
    anisotropic grids a genuinely negative half-trans must propagate into the
    harmonic mean rather than be silently flipped positive.
    """
    d = face_centroids - centroids[cells]  # (nf, dim)
    Kd = np.einsum("fij,fj->fi", K[cells], d)
    num = areas * sgn * np.einsum("fi,fi->f", Kd, normals)
    den = np.einsum("fi,fi->f", d, d)
    with np.errstate(divide="ignore", invalid="ignore"):
        T = np.where(den > 0, num / den, 0.0)
    return T


def compute_half_face_trans(
    geo: TwoPointFiniteVolumeGeometry, perm
) -> tuple[np.ndarray, np.ndarray]:
    """Half-face transmissibilities for interior faces.

    Returns (T_left, T_right), each (n_faces,) — the two half-face trans of
    each interior face (reference finite-volume.jl:3-155).
    """
    K = expand_perm(perm, geo.dim)
    L = geo.neighbors[:, 0]
    R = geo.neighbors[:, 1]
    T_l = _half_trans(L, geo.cell_centroids, geo.face_centroids, geo.normals,
                      geo.areas, K, sgn=+1.0)
    T_r = _half_trans(R, geo.cell_centroids, geo.face_centroids, geo.normals,
                      geo.areas, K, sgn=-1.0)
    return T_l, T_r


def compute_face_trans(geo_or_mesh, perm) -> np.ndarray:
    """Harmonic-average face transmissibilities (reference finite-volume.jl:157).

    Accepts a geometry or a mesh.
    """
    geo = _as_geo(geo_or_mesh)
    T_l, T_r = compute_half_face_trans(geo, perm)
    # Plain signed harmonic mean, as the reference (finite-volume.jl:224-233):
    # 1 / (1/T_l + 1/T_r). Degenerate half-trans of exactly zero yields T = 0.
    with np.errstate(divide="ignore", invalid="ignore"):
        s = 1.0 / T_l + 1.0 / T_r
        T = np.where((T_l != 0) & (T_r != 0) & (s != 0), 1.0 / s, 0.0)
    return T


def compute_boundary_trans(geo_or_mesh, perm) -> np.ndarray:
    """Half-face transmissibilities of boundary faces
    (reference finite-volume.jl:220-255)."""
    geo = _as_geo(geo_or_mesh)
    K = expand_perm(perm, geo.dim)
    cells = geo.boundary_neighbors
    return _half_trans(cells, geo.cell_centroids, geo.boundary_centroids,
                       geo.boundary_normals, geo.boundary_areas, K)


def compute_face_gdz(geo_or_mesh, gravity=None) -> np.ndarray:
    """g * Δz across each interior face: g . (x_R - x_L)
    (reference finite-volume.jl:290-313). ``gravity`` defaults to
    (0, ..., -9.80665) pointing down the last axis."""
    geo = _as_geo(geo_or_mesh)
    if gravity is None:
        gravity = np.zeros(geo.dim)
        gravity[-1] = -9.80665
    gravity = np.asarray(gravity, dtype=np.float64)
    dx = geo.cell_centroids[geo.neighbors[:, 1]] - geo.cell_centroids[geo.neighbors[:, 0]]
    return dx @ gravity


def _as_geo(geo_or_mesh) -> TwoPointFiniteVolumeGeometry:
    if isinstance(geo_or_mesh, TwoPointFiniteVolumeGeometry):
        return geo_or_mesh
    if hasattr(geo_or_mesh, "tpfv_geometry"):
        return geo_or_mesh.tpfv_geometry()
    if hasattr(geo_or_mesh, "geometry") and geo_or_mesh.geometry is not None:
        return geo_or_mesh.geometry
    raise TypeError(f"Cannot extract geometry from {type(geo_or_mesh)}")


def half_face_map(neighbors: np.ndarray, n_cells: int):
    """Padded ELL half-face map: for each cell, its incident faces and signs.

    Counterpart of the CSR half-face maps (reference src/domains.jl:101); here
    padded to the max vertex degree for static shapes.

    Returns dict with:
      - ``faces``  (n_cells, Dmax) int32: incident face index (0 pad)
      - ``signs``  (n_cells, Dmax) float: +1 if cell is left (outflux), -1 right
      - ``mask``   (n_cells, Dmax) bool
      - ``degree`` (n_cells,) int32
    """
    n_faces = neighbors.shape[0]
    deg = np.zeros(n_cells, dtype=np.int64)
    np.add.at(deg, neighbors[:, 0], 1)
    np.add.at(deg, neighbors[:, 1], 1)
    dmax = int(deg.max()) if n_cells and n_faces else 0
    faces = np.zeros((n_cells, max(dmax, 1)), dtype=np.int32)
    signs = np.zeros((n_cells, max(dmax, 1)))
    mask = np.zeros((n_cells, max(dmax, 1)), dtype=bool)
    fill = np.zeros(n_cells, dtype=np.int64)
    for f in range(n_faces):
        l, r = neighbors[f]
        faces[l, fill[l]] = f
        signs[l, fill[l]] = 1.0
        mask[l, fill[l]] = True
        fill[l] += 1
        faces[r, fill[r]] = f
        signs[r, fill[r]] = -1.0
        mask[r, fill[r]] = True
        fill[r] += 1
    return {
        "faces": faces,
        "signs": signs,
        "mask": mask,
        "degree": deg.astype(np.int32),
    }


# ---------------------------------------------------------------------------
# Differentiable (JAX) variants — the DataDomain -> parameters chain rule.
#
# The reference exposes this chain via parameters_jacobian_wrt_data_domain
# (variables/vectorization.jl:281): gradients of an objective with respect to
# model parameters (transmissibilities, pore volumes) pull back to raw
# DataDomain fields (permeability, porosity). JAX-native: the geometry stays
# static numpy; the differentiable fields are traced with jnp so jax.vjp /
# jacfwd give the chain-rule Jacobian with no sparsity tracing.
# ---------------------------------------------------------------------------


def expand_perm_ad(perm, dim: int):
    """jnp counterpart of expand_perm (differentiable in perm).

    KEEP IN SYNC with the numpy trio above — the pairing is enforced by
    tests/test_data_domain_chain.py::test_parameters_from_data_domain_
    matches_setup (equality to 1e-12 between the two paths)."""
    import jax.numpy as jnp

    perm = jnp.asarray(perm)
    n = perm.shape[0]
    if perm.ndim == 3:
        return perm
    if perm.ndim == 1:
        return perm[:, None, None] * jnp.eye(dim)
    m = perm.shape[1]
    if m == dim:  # diagonal
        return perm[:, :, None] * jnp.eye(dim)
    if dim == 2 and m == 3:
        xx, xy, yy = perm[:, 0], perm[:, 1], perm[:, 2]
        return jnp.stack([jnp.stack([xx, xy], -1),
                          jnp.stack([xy, yy], -1)], -2)
    if dim == 3 and m == 6:
        xx, xy, xz, yy, yz, zz = (perm[:, i] for i in range(6))
        return jnp.stack([jnp.stack([xx, xy, xz], -1),
                          jnp.stack([xy, yy, yz], -1),
                          jnp.stack([xz, yz, zz], -1)], -2)
    raise ValueError(f"Cannot interpret permeability of shape {perm.shape} "
                     f"in {dim}D")


def _half_trans_ad(cells, centroids, face_centroids, normals, areas, K, sgn):
    import jax.numpy as jnp

    d = jnp.asarray(face_centroids) - jnp.asarray(centroids)[cells]
    Kd = jnp.einsum("fij,fj->fi", K[cells], d)
    num = jnp.asarray(areas) * sgn * jnp.einsum("fi,fi->f", Kd,
                                                jnp.asarray(normals))
    den = jnp.einsum("fi,fi->f", d, d)
    return jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), 0.0)


def compute_face_trans_ad(geo_or_mesh, perm):
    """Differentiable face transmissibilities: jnp in, jnp out, same math as
    compute_face_trans (signed harmonic mean of signed half-trans)."""
    import jax.numpy as jnp

    geo = _as_geo(geo_or_mesh)
    K = expand_perm_ad(perm, geo.dim)
    L = geo.neighbors[:, 0]
    R = geo.neighbors[:, 1]
    T_l = _half_trans_ad(L, geo.cell_centroids, geo.face_centroids,
                         geo.normals, geo.areas, K, +1.0)
    T_r = _half_trans_ad(R, geo.cell_centroids, geo.face_centroids,
                         geo.normals, geo.areas, K, -1.0)
    ok = (T_l != 0) & (T_r != 0)
    s = (1.0 / jnp.where(ok, T_l, 1.0)) + (1.0 / jnp.where(ok, T_r, 1.0))
    ok = ok & (s != 0)
    return jnp.where(ok, 1.0 / jnp.where(ok, s, 1.0), 0.0)


def compute_boundary_trans_ad(geo_or_mesh, perm):
    """Differentiable boundary half-face transmissibilities."""
    geo = _as_geo(geo_or_mesh)
    K = expand_perm_ad(perm, geo.dim)
    return _half_trans_ad(geo.boundary_neighbors, geo.cell_centroids,
                          geo.boundary_centroids, geo.boundary_normals,
                          geo.boundary_areas, K, +1.0)
