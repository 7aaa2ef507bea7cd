"""Generate the committed end-to-end golden fixtures under tests/golden/.

The expected outputs are computed INDEPENDENTLY of the engine under
test: all inference math comes from the per-voxel NumPy oracles
(tests/oracle.py update equations; the Levenberg scheme of
tests/oracle_nlls.py re-stated here for a general design matrix).
Only file I/O (NIFTI read/write, [V,T] Fortran-order voxel packing)
uses the repo's io layer, and the packing is stated explicitly below
so the fixtures do not silently inherit engine conventions.

Inputs are the reference's shipped small test volume
(/root/reference/test/test_data_small.nii.gz, 3x3x2x106, no mask: the
shipped test_mask_small.nii.gz belongs to the UNSHIPPED full-size
test_data.nii.gz, see docs/PARITY.md) and the shipped VEST design
test_linear_design.mat. Configs mirror the reference's golden output
dirs (outdata_poly / outdata_linear_vb / outdata_linear_spatialvb /
outdata_linear_nlls, provenance READMEs e.g.
/root/reference/test/outdata_poly/README:1-3).

Run:  python tests/golden/generate_fixtures.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from oracle import vb_voxel  # noqa: E402  (tests/oracle.py)

REF = "/root/reference/test"
OUT = os.path.dirname(os.path.abspath(__file__))

# NLLS lane constants (inference_nlls.cc:135-214 semantics, identical
# to tests/oracle_nlls.py)
LAMBDA_INIT, LAMBDA_GROW, LAMBDA_SHRINK, LAMBDA_MAX = 1e-3, 10.0, 0.1, 1e10
PREC_DIAG_FLOOR = 1e-6
CFTOL = 1e-5          # engine's f32-scaled relative cost tolerance
PLATEAU_LAMBDA = 1.0  # engine's rejected-plateau convergence guard


def read_vest(path):
    """Minimal VEST parser (read_matrix_file semantics, tools.cc:27-40)."""
    rows, in_matrix = [], False
    with open(path) as f:
        for line in f:
            if line.startswith("/Matrix"):
                in_matrix = True
                continue
            if in_matrix and line.strip():
                rows.append([float(x) for x in line.split()])
    return np.array(rows)


def load_voxels():
    from fabber_core_tpu.io import nifti
    img = nifti.load(os.path.join(REF, "test_data_small.nii.gz"))
    vol = np.asarray(img.data, np.float64)
    shape = vol.shape[:3]
    # x-fastest (Fortran) voxel order — core/volume.py convention
    data = vol.reshape(-1, vol.shape[3], order="F")
    return data, shape, img


def save_vol(arr, shape, like, path):
    """[V] or [V,N] voxel array -> 3-D/4-D NIFTI in Fortran order."""
    from fabber_core_tpu.io import nifti
    arr = np.asarray(arr, np.float64)
    if arr.ndim == 2 and arr.shape[1] == 1:
        arr = arr[:, 0]  # single-column products save as 3-D volumes
    if arr.ndim == 1:
        vol = arr.reshape(shape, order="F")
    else:
        vol = arr.reshape(shape + (arr.shape[1],), order="F")
    nifti.save(nifti.NiftiImage(vol.astype(np.float32),
                                pixdims=like.pixdims,
                                affine_bytes=like.affine_bytes), path)


def pack_mvn(means, cov):
    """finalMVN rows per voxel: row-major lower-tri cov ++ means ++ 1
    (dist_mvn.cc:377-437)."""
    nv, p = means.shape
    r, c = np.tril_indices(p)
    # np.tril_indices is already row-major over the lower triangle
    return np.concatenate([cov[:, r, c], means,
                           np.ones((nv, 1))], axis=1)


def vb_expected(data, design, niter=10):
    """Oracle VB over all voxels for a fixed-design model with
    N(0,1e12) priors (poly/linear defaults)."""
    nv = data.shape[0]
    p = design.shape[1]
    prior_mean = np.zeros(p)
    prior_prec = np.full(p, 1e-12)

    def eval_fn(params):
        return design @ params

    def jac_fn(params):
        return design

    means = np.zeros((nv, p))
    cov = np.zeros((nv, p, p))
    fs = np.zeros(nv)
    nb = np.zeros((nv, 1))
    nc = np.zeros((nv, 1))
    for v in range(nv):
        r = vb_voxel(eval_fn, jac_fn, data[v], prior_mean, prior_prec,
                     np.zeros(p), np.full(p, 1e12), niter)
        means[v], cov[v], fs[v] = r["means"], r["cov"], r["F"]
        nb[v, 0], nc[v, 0] = r["phi_b"][0], r["phi_c"][0]
    return means, cov, fs, nb, nc


def nlls_expected(data, design, max_its=100):
    """Levenberg NLLS for a linear (identity-transform) design model."""
    nv = data.shape[0]
    p = design.shape[1]
    jac = design.T  # [P,T], constant
    means = np.zeros((nv, p))
    cov = np.zeros((nv, p, p))
    for v in range(nv):
        y = data[v]
        pv = np.zeros(p)
        cost = float(np.sum((y - design @ pv) ** 2))
        lam = LAMBDA_INIT
        for _ in range(max_its):
            r = y - design @ pv
            jtj = jac @ jac.T
            delta = np.linalg.solve(jtj + lam * np.eye(p), jac @ r)
            trial = pv + delta
            tcost = float(np.sum((y - design @ trial) ** 2))
            converged = False
            if np.isfinite(tcost) and tcost < cost:
                converged = (cost - tcost) <= CFTOL * max(abs(tcost),
                                                          1e-30)
                pv, cost = trial, tcost
                lam *= LAMBDA_SHRINK
            else:
                # rejected-plateau exit (inference/nlls.py semantics)
                converged = (np.isfinite(tcost)
                             and lam >= PLATEAU_LAMBDA
                             and (tcost - cost) <= CFTOL
                             * max(abs(cost), 1e-30))
                lam *= LAMBDA_GROW
            if converged or lam > LAMBDA_MAX:
                break
        mse = cost / (len(y) - p)
        prec = (jac @ jac.T) / mse
        for i in range(p):
            prec[i, i] = max(prec[i, i], PREC_DIAG_FLOOR)
        means[v] = pv
        cov[v] = np.linalg.inv(prec)
    return means, cov


def write_config(name, shape, like, names, means, cov, fs=None,
                 noise_bc=None):
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    std = np.sqrt(np.diagonal(cov, axis1=1, axis2=2))
    for i, pname in enumerate(names):
        save_vol(means[:, i], shape, like, f"{d}/mean_{pname}.nii.gz")
        save_vol(std[:, i], shape, like, f"{d}/std_{pname}.nii.gz")
        save_vol(means[:, i] / std[:, i], shape, like,
                 f"{d}/zstat_{pname}.nii.gz")
    all_means, all_cov = means, cov
    if noise_bc is not None:
        nb, nc = noise_bc
        phi_mean = nb * nc          # Gamma mean
        phi_var = nb * nb * nc      # Gamma variance
        save_vol(phi_mean[:, 0], shape, like, f"{d}/noise_means.nii.gz")
        save_vol(np.sqrt(phi_var[:, 0]), shape, like,
                 f"{d}/noise_stdevs.nii.gz")
        nv, p = means.shape
        all_means = np.concatenate([means, phi_mean], axis=1)
        all_cov = np.zeros((nv, p + 1, p + 1))
        all_cov[:, :p, :p] = cov
        all_cov[:, p, p] = phi_var[:, 0]
    save_vol(pack_mvn(all_means, all_cov), shape, like,
             f"{d}/finalMVN.nii.gz")
    if fs is not None:
        save_vol(fs, shape, like, f"{d}/freeEnergy.nii.gz")
    with open(f"{d}/paramnames.txt", "w") as f:
        f.write("\n".join(names) + "\n")
    print(f"{name}: {len(os.listdir(d))} files")


def main():
    data, shape, img = load_voxels()
    t = np.arange(1, data.shape[1] + 1, dtype=np.float64)
    poly_design = t[:, None] ** np.arange(3)[None, :]
    lin_design = read_vest(os.path.join(REF, "test_linear_design.mat"))
    lin_names = [f"Parameter_{i + 1}" for i in range(lin_design.shape[1])]

    m, c, f, nb, nc = vb_expected(data, poly_design)
    write_config("poly_vb", shape, img, ["c0", "c1", "c2"], m, c, f,
                 (nb, nc))

    m, c, f, nb, nc = vb_expected(data, lin_design)
    write_config("linear_vb", shape, img, lin_names, m, c, f, (nb, nc))
    # spatialvb with the default all-N priors has no cross-voxel
    # coupling: each sweep applies exactly the voxelwise update
    # sequence (priors -> theta -> noise -> relinearize -> F), so the
    # expected outputs equal the voxelwise run's — mirroring the
    # reference, whose outdata_linear_spatialvb golden run is all-N
    write_config("linear_spatialvb", shape, img, lin_names, m, c, f,
                 (nb, nc))

    m, c = nlls_expected(data, lin_design)
    write_config("linear_nlls", shape, img, lin_names, m, c)


if __name__ == "__main__":
    main()
