"""End-to-end check of eigenex_tpu on an NVIDIA GPU.

Run from the repository root:

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the mesh path on four cards

One card runs these phases in order; any failure exits non-zero and
prints no result line:

- ``device``: JAX's default devices are GPUs; prints their kind and
  count, the JAX version, ``nvidia-smi``'s name and power limit, and the
  compile-cache directory.
- ``kernels``: every SpMV/SpMM route at real widths against a plain f64
  ``scipy.sparse`` reference built from the same permuted, padded
  operator (relative 2-norm error ≤ 1e-5), with its time, bytes/s and
  compiled memory; that a jitted ``SymBSRMatrix`` SpMV compiles the
  kernel; and block Lanczos (SpMM) on the banded operator through both
  routes.
- ``eigsh``: BASELINE config 3 — the total-Sz=0 sector of the L=24
  Heisenberg chain through ``eigsh`` on the ``accelerate()``-packed
  operator, called as users call it, against
  ``scipy.sparse.linalg.eigsh`` in f64; then the same solve through the
  kernel and through XLA, and block Lanczos through the kernel.
- ``eigs``: BASELINE config 2 — convection–diffusion at nx=1000
  (n=10⁶) through ``eigs`` on the ``accelerate()``-packed operator:
  converged, and certified by each pair's f64 backward error.

``--four-cards`` runs only ``eigsh(accelerate=True, mesh=make_mesh(4),
matvec_mode="sym_halo")`` on the L=24 operator, checks that every shard
of the operator and of the basis sits on its own device, and compares E0
with the one-card f64-refined value.

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: relative 2-norm tolerance of every SpMV/SpMM route against the f64
#: reference: f32 accumulation over ~13×128 terms per row, atomics that
#: add in a varying order, and no TF32 anywhere
SPMV_TOL = 1e-5

#: set by a rehearsal on the CPU to run the GPU kernel in interpret mode
INTERPRET = False


def run_phase(name, fn, *args):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    try:
        out = fn(*args)
    except Exception:
        traceback.print_exc()
        print(f"== {name} FAILED", flush=True)
        sys.exit(1)
    print(f"== {name} ok in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def phase_device():
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's default devices are {devices[0].platform!r}")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(f"device_kind {devices[0].device_kind!r}, {len(devices)} device(s), jax {jax.__version__}")
    print(out.stdout.strip())
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    return dict(platform=devices[0].platform, kind=devices[0].device_kind, count=len(devices))


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------
def heisenberg_triplets(L: int):
    from eigenex_tpu import native

    r, c, v, dim = native.heisenberg_sector(L, L // 2, 1.0, 1.0, False)
    return r, c, v, dim


def convection_diffusion_triplets(nx: int, conv: float = 0.4):
    """5-point Laplacian + upwind convection on an nx × nx grid
    (BASELINE config 2, as ``benchmarks/bench_arnoldi.py`` builds it)."""
    n = nx * nx
    i = np.arange(nx)
    jj, ii = np.meshgrid(i, i)
    u = (ii * nx + jj).ravel()
    rows, cols, vals = [u], [u], [np.full(n, 4.0)]
    for mask, off, val in (
        (ii > 0, -nx, -1.0 - conv),
        (ii < nx - 1, nx, -1.0 + conv),
        (jj > 0, -1, -1.0 - conv),
        (jj < nx - 1, 1, -1.0 + conv),
    ):
        uu = u[mask.ravel()]
        rows.append(uu)
        cols.append(uu + off)
        vals.append(np.full(len(uu), val))
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n


def banded_bsr(nbr: int, bm: int):
    """``bench.py``'s operator: symmetric block-tridiagonal, dense blocks."""
    sys.path.insert(0, ROOT)
    from bench import banded_block_bsr

    return banded_block_bsr(nbr, bm)


def permuted_csr(acc, r, c, v):
    """f64 CSR of the packed operator's permuted, padded coordinates:
    entry (i, j) is A[row_perm[i], perm[j]]."""
    import scipy.sparse as sp

    inv_c = np.empty(len(acc.perm), np.int64)
    inv_c[acc.perm] = np.arange(len(acc.perm))
    rp = acc.row_perm if acc.row_perm is not None else acc.perm
    inv_r = np.empty(len(rp), np.int64)
    inv_r[rp] = np.arange(len(rp))
    return sp.csr_matrix((np.asarray(v, np.float64), (inv_r[r], inv_c[c])), shape=acc.shape)


def bsr_csr(bsr):
    """f64 scipy BSR of a BSR-ELL container (padding slots add zeros)."""
    import scipy.sparse as sp

    data = np.asarray(bsr.data, np.float64)
    nbr, kmax, bm, bn = data.shape
    return sp.bsr_matrix(
        (data.reshape(-1, bm, bn), np.asarray(bsr.block_cols).reshape(-1),
         np.arange(0, nbr * kmax + 1, kmax)),
        shape=bsr.shape,
    )


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------
def copy_bandwidth():
    """Bytes/s of a large device-to-device copy (read + write), the
    practical ceiling for a memory-bound route in this call."""
    import jax
    import jax.numpy as jnp

    from eigenex_tpu.utils.benchtime import timed_median

    a = jnp.ones((1 << 29,), jnp.float32)
    add = jax.jit(lambda z: z + 1.0)
    t, _ = timed_median(lambda: add(a), reps=10)
    bw = 2 * a.size * 4 / t
    print(f"copy: {2 * a.size * 4 / 2**30:.0f} GiB moved in {t * 1e3:.3f} ms = {bw / 1e9:.1f} GB/s")
    return bw


def _routes():
    """name → fn(container, x)."""
    from eigenex_tpu.ops.pallas_spmv import sym_bsr_matmat_pallas, sym_bsr_matvec_pallas

    return {
        "sym kernel": lambda s, x: (
            sym_bsr_matvec_pallas if x.ndim == 1 else sym_bsr_matmat_pallas
        )(s, x, interpret=INTERPRET),
        "sym xla": lambda s, x: s._xla_matvec(x) if x.ndim == 1 else s._xla_matmat(x),
        "bsr xla": lambda b, x: b.matvec(x) if x.ndim == 1 else b.matmat(x),
    }


def _block_bytes(op, route) -> int:
    """Block bytes ``route`` reads per call, from the container's shapes:
    the kernel skips padding slots (column ≤ row), the XLA routes read
    every slot, the symmetric one twice."""
    if route == "bsr xla":
        return op.data.size * op.data.dtype.itemsize
    blk = op.upper_data[0, 0].size * op.upper_data.dtype.itemsize
    if route == "sym xla":
        return (op.diag_data.size + 2 * op.upper_data.size) * op.upper_data.dtype.itemsize
    uc = np.asarray(op.upper_cols)
    real = int((uc > np.arange(uc.shape[0])[:, None]).sum())
    return (op.n_block_rows + real) * blk


def check_route(label, route, op, ref, ps, copy_bw):
    """Compare ``route`` on ``op`` with ``ref @ X`` for every p in ``ps``
    (0 = matvec), time it, and print its compiled memory."""
    import jax
    import jax.numpy as jnp

    from eigenex_tpu.ops.pallas_spmv import _MAX_COLS
    from eigenex_tpu.utils.benchtime import timed_median

    fn = _routes()[route]
    jfn = jax.jit(fn)
    block_bytes = _block_bytes(op, route)
    n = op.shape[1]
    rng = np.random.default_rng(7)
    for p in ps:
        X = rng.standard_normal(n if p == 0 else (n, p))
        want = ref @ X
        Xd = jnp.asarray(X, jnp.float32)
        got = np.asarray(jfn(op, Xd), np.float64)
        err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        t, _ = timed_median(lambda: jfn(op, Xd), reps=10)
        width = max(p, 1)
        # the kernel's SpMM pads p to a power of two >= 16 and reads the
        # blocks once per group of _MAX_COLS columns
        groups = -(-max(16, 1 << (width - 1).bit_length()) // _MAX_COLS)
        reads = groups if route == "sym kernel" and p else 1
        nbytes = reads * block_bytes + 2 * 4 * op.shape[0] * width
        mem = jfn.lower(op, Xd).compile().memory_analysis()
        shape = "matvec" if p == 0 else f"matmat p={p}"
        print(
            f"{label} {route} {shape}: rel err {err:.2e}, {t * 1e3:.3f} ms, "
            f"{nbytes / t / 1e9:.1f} GB/s moved (from the container's shapes; "
            f"{nbytes / t / copy_bw:.0%} of copy); memory: "
            f"args {mem.argument_size_in_bytes / 2**30:.2f} GiB, "
            f"temp {mem.temp_size_in_bytes / 2**30:.2f} GiB, "
            f"out {mem.output_size_in_bytes / 2**20:.1f} MiB",
            flush=True,
        )
        if not err <= SPMV_TOL:
            raise AssertionError(f"{label} {route} {shape}: rel err {err:.2e} > {SPMV_TOL}")


def check_jit_route(sym):
    """``A.matvec`` / ``A.matmat`` inside a user's jit compile the kernel
    on the card (the route is staged while tracing)."""
    import jax
    import jax.numpy as jnp

    n = sym.shape[0]
    for method, x, name in (
        ("matvec", jnp.zeros((n,), jnp.float32), "sym_bsr_spmv"),
        ("matmat", jnp.zeros((n, 8), jnp.float32), "sym_bsr_spmm"),
    ):
        text = jax.jit(lambda s, x: getattr(s, method)(x)).lower(sym, x).as_text()
        if name not in text:
            raise AssertionError(f"jitted {method} did not lower to the {name} kernel")
        print(f"jitted SymBSRMatrix.{method} lowers to the {name} kernel")


def phase_kernels(ctx):
    import jax.numpy as jnp

    from eigenex_tpu.sparse.sym_bsr import sym_bsr_from_bsr

    copy_bw = copy_bandwidth()
    ps = (0, 8, 64)
    check_jit_route(ctx["acc3"].matrix)

    # config 3: the packed L=24 sector operator, bf16 (as packed) and f32
    acc, ref = ctx["acc3"], ctx["csr3"]
    sym = acc.matrix
    real = np.asarray(sym.upper_cols) > np.arange(sym.n_block_rows)[:, None]
    print(
        f"L={ctx['L']} SymBSR: {sym.shape[0]:,} rows, upper {sym.upper_data.shape}, "
        f"{real.sum(1).mean():.2f} real upper blocks per block row of {real.shape[1]}"
    )
    for dt in (jnp.bfloat16, jnp.float32):
        s = sym.astype(dt)
        label = f"L={ctx['L']} {jnp.dtype(dt).name}"
        check_route(label, "sym kernel", s, ref, ps, copy_bw)
        # the XLA formulation's SpMM gathers (nbr, ku, 128, p) panels and
        # transposes the blocks to f32: at p=64, or from f32 storage, its
        # temporaries do not fit beside the operator, so bf16 p=8 only
        xla_ps = (0, 8) if dt == jnp.bfloat16 else (0,)
        check_route(label, "sym xla", s, ref, xla_ps, copy_bw)
        del s

    # bench.py's banded operator: general BSR on XLA, and its symmetric
    # storage on both routes
    bsr = banded_bsr(ctx["nbr"], 128)
    for dt in (jnp.bfloat16, jnp.float32):
        b = bsr.astype(dt)
        ref = bsr_csr(b)
        label = f"banded {ctx['nbr']}x3x128^2 {jnp.dtype(dt).name}"
        check_route(label, "bsr xla", b, ref, ps, copy_bw)
        s = sym_bsr_from_bsr(bsr).astype(dt)
        check_route(label, "sym kernel", s, ref, ps, copy_bw)
        check_route(label, "sym xla", s, ref, ps, copy_bw)
        for b in (8, 64):
            spmm_consumer(label, s, b)

    # config 2: the packed convection-diffusion operator (general BSR)
    acc2 = ctx["acc2"]
    print(f"config 2 BSR: {acc2.matrix.shape[0]:,} rows, blocks {acc2.matrix.data.shape} {acc2.matrix.dtype}")
    check_route(f"config2 nx={ctx['nx']}", "bsr xla", acc2.matrix, ctx["csr2"], ps, copy_bw)


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------
def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def scipy_ground_state(r, c, v, dim) -> float:
    """f64 reference E0 of the config-3 operator (scipy, host)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    t0 = time.perf_counter()
    H = sp.csr_matrix((v, (r, c)), shape=(dim, dim))
    e, _ = spla.eigsh(H, k=1, which="SA", tol=1e-12, ncv=32)
    print(f"scipy eigsh f64 reference: E0 = {e[0]:.12f} in {time.perf_counter() - t0:.1f} s")
    return float(e[0])


def phase_eigsh(ctx):
    """Config 3 through ``eigsh`` as users call it (no precision
    context): the f32 E0 within 1e-5 and the f64-refined E0 within 1e-8
    of scipy, and converged.  The iteration count under
    ``default_matmul_precision("highest")`` is printed beside it."""
    import jax

    from eigenex_tpu.solvers.api import eigsh
    from eigenex_tpu.solvers.refine import rayleigh_refine
    from eigenex_tpu.sparse.coo import COOMatrix

    acc = ctx["acc3"]
    r, c, v, dim = ctx["trip3"]
    coo64 = COOMatrix(r.astype(np.int64), c.astype(np.int64), v, (dim, dim))
    e_ref = ctx["e_ref"] = scipy_ground_state(r, c, v, dim)
    kw = dict(k=1, which="SA", tol=1e-8, max_subspace=160)

    def solve(op=acc, **extra):
        t0 = time.perf_counter()
        res = eigsh(op, **kw, **extra)
        return res, time.perf_counter() - t0

    _, t_cold = solve()
    res, t_warm = solve()
    e32 = float(res.eigenvalues[0])
    lam, resid = rayleigh_refine(coo64, np.asarray(res.eigenvectors))
    err32 = abs(e32 - e_ref) / abs(e_ref)
    err64 = abs(lam[0] - e_ref) / abs(e_ref)
    print(
        f"eigsh L={ctx['L']} (dim {dim:,}, {len(v):,} nnz): pack {acc.stats['pack_seconds']:.1f} s, "
        f"solve cold {t_cold:.2f} s, warm {t_warm:.2f} s, {res.iterations} iterations "
        f"({res.termination}); E0 f32 {e32:.10f} (rel err {err32:.2e}), rayleigh_refine "
        f"{lam[0]:.12f} (rel err {err64:.2e}), f64 residual |Hv-Ev|/|E| "
        f"{resid[0] / abs(lam[0]):.2e}; peak_bytes_in_use {_peak_bytes()}",
        flush=True,
    )
    with jax.default_matmul_precision("highest"):
        res_h, _ = solve()
    print(f"same solve under default_matmul_precision('highest'): {res_h.iterations} iterations "
          f"({res_h.termination})")
    if res.termination != "converged":
        raise AssertionError(f"eigsh ended {res.termination!r}")
    if not err32 <= 1e-5:
        raise AssertionError(f"f32 E0 rel err {err32:.2e} > 1e-5")
    if not err64 <= 1e-8:
        raise AssertionError(f"refined E0 rel err {err64:.2e} > 1e-8")

    # the kernel decision, end to end: the same solve from the same start
    # vector through the kernel route and through XLA's
    v0 = acc.embed(np.random.default_rng(0).standard_normal(dim))
    for route, use_pallas in (("kernel", True), ("xla", False)):
        op = acc.matrix.as_linear_operator(use_pallas=use_pallas)
        solve(op, v0=v0)
        res_r, t = solve(op, v0=v0)
        print(
            f"eigsh L={ctx['L']} through the {route} route (warm): {t:.2f} s, "
            f"{res_r.iterations} iterations, {t / res_r.iterations * 1e3:.2f} ms/iteration",
            flush=True,
        )
    # XLA's SpMM needs a 15.5 GiB f32 transpose of the blocks beside the
    # operator and the basis, which does not fit: the kernel route only
    spmm_consumer(f"L={ctx['L']} bf16", acc.matrix, 8, routes=("kernel",))


def spmm_consumer(label, sym, b, routes=("kernel", "xla")):
    """The SpMM route decision end to end: block Lanczos (block width
    ``b``, one SpMM per block step, 20 block steps) from one start block
    through each route, warm; the routes' E0 must agree."""
    import jax

    from eigenex_tpu.solvers.block_lanczos import BlockLanczosEigenSolver, BlockLanczosOptions
    from eigenex_tpu.utils.prng import random_matrix

    n = sym.shape[0]
    opts = BlockLanczosOptions(block_size=b, max_subspace=20 * b, tolerance=1e-6)
    V0 = random_matrix(jax.random.PRNGKey(1), b, n, jax.numpy.float32)
    out = {}
    for route in routes:
        op = sym.as_linear_operator(use_pallas=route == "kernel")
        for _ in range(2):
            t0 = time.perf_counter()
            res = BlockLanczosEigenSolver(op, opts).set_initial_block(V0).compute()
            t = time.perf_counter() - t0
        out[route] = e0 = float(res.eigenvalues[0])
        print(
            f"block Lanczos {label}, b={b}, through the {route} route (warm): {t:.2f} s, "
            f"{res.iterations} iterations ({res.termination}); E0 {e0:.10f}",
            flush=True,
        )
    if not np.ptp(list(out.values())) <= 1e-5 * abs(out[routes[0]]):
        raise AssertionError(f"block Lanczos {label}: routes disagree {out}")


#: f64 backward error allowed to config 2's f32 pairs: eigs stops when
#: each returned pair's Ritz residual estimate is within its f32 default
#: tolerance 1e-4 (relative to the largest |λ|); the f64 residual may
#: exceed the estimate by the rounding of the f32 Arnoldi relation
EIGS_BACKWARD_TOL = 2e-4


def exact_top_eigenvalues(nx: int, conv: float = 0.4, k: int = 4):
    """Config 2's largest eigenvalues in closed form: the operator is a
    Kronecker sum of two tridiagonal Toeplitz matrices (diagonal 2,
    off-diagonals −(1±conv)), whose eigenvalues are
    2 + 2·sqrt(1−conv²)·cos(jπ/(nx+1))."""
    j = np.arange(1, k + 1)
    one_d = 2 * np.sqrt(1 - conv**2) * np.cos(j * np.pi / (nx + 1))
    return np.sort((4 + one_d[:, None] + one_d[None, :]).ravel())[::-1][:k]


def phase_eigs(ctx):
    """Config 2 through ``eigs(accelerate=True)``.  The upwind operator's
    eigenvectors are so ill-conditioned (its symmetrizer has condition
    ((1+c)/(1-c))^((nx-1)/2), about 1e184 at nx=1000) that ANY
    floating-point method returns eigenvalues scattered over the
    pseudospectrum, well away from the exact ones (printed beside them):
    a forward comparison cannot pass for any solver.  The well-posed
    check is that the solve converged and each pair's f64 backward error
    ‖Ax − λx‖/(|λ|‖x‖) is within the solver's tolerance: every returned
    pair is an exact eigenpair of a matrix within 2e-4·|λ| of A.  The
    kernels phase checks the same packed operator's matvec everywhere at
    1e-5."""
    import scipy.sparse as sp

    from eigenex_tpu.solvers.api import eigs

    acc2 = ctx["acc2"]
    r, c, v, n = ctx["trip2"]
    A = sp.csr_matrix((v, (r, c)), shape=(n, n))
    t0 = time.perf_counter()
    res = eigs(acc2, k=4)
    t_solve = time.perf_counter() - t0
    lam = np.asarray(res.eigenvalues)
    X = np.asarray(res.eigenvectors, np.complex128)
    X = X / np.linalg.norm(X, axis=0)
    bw = np.linalg.norm(A @ X - X * lam[None, :], axis=0) / np.abs(lam)
    print(
        f"eigs config 2 nx={ctx['nx']} (n={n:,}): solve {t_solve:.2f} s, "
        f"{res.iterations} iterations ({res.termination}); eigenvalues {lam}; "
        f"f64 backward errors {bw}; exact top eigenvalues "
        f"{exact_top_eigenvalues(ctx['nx'])}; peak_bytes_in_use {_peak_bytes()}",
        flush=True,
    )
    if res.termination != "converged":
        raise AssertionError(f"eigs ended {res.termination!r}")
    if not np.all(bw <= EIGS_BACKWARD_TOL):
        raise AssertionError(f"eigs backward error {bw.max():.2e} > {EIGS_BACKWARD_TOL}")


def phase_four_cards(ctx):
    import jax

    import eigenex_tpu.parallel.distributed as dist
    from eigenex_tpu.parallel.mesh import make_mesh
    from eigenex_tpu.solvers.api import eigsh
    from eigenex_tpu.solvers.refine import rayleigh_refine
    from eigenex_tpu.sparse.coo import COOMatrix

    r, c, v, dim = ctx["trip3"]
    acc = ctx["acc3"]
    coo64 = COOMatrix(r.astype(np.int64), c.astype(np.int64), v, (dim, dim))

    seen = {}
    steps = dist.distributed_arnoldi_steps

    def spy(bsr, state, *a, **k):
        out = steps(bsr, state, *a, **k)
        seen["parts"], seen["V"] = k.get("halo_parts"), out.V
        return out

    kw = dict(k=1, which="SA", tol=1e-8, max_subspace=160)
    # one-card reference: the same solve on device 0, refined on host f64
    res1 = eigsh(acc, **kw)
    e1 = float(rayleigh_refine(coo64, np.asarray(res1.eigenvectors))[0][0])
    print(f"one card: E0 refined {e1:.12f} ({res1.iterations} iterations)")
    dist.distributed_arnoldi_steps = spy
    try:
        t0 = time.perf_counter()
        res = eigsh(acc, mesh=make_mesh(4), matvec_mode="sym_halo", **kw)
        t_mesh = time.perf_counter() - t0
    finally:
        dist.distributed_arnoldi_steps = steps

    def placement(name, a, axis):
        shards = a.addressable_shards
        devs = {s.device for s in shards}
        sizes = {s.data.shape[axis] for s in shards}
        if len(shards) != 4 or len(devs) != 4 or sizes != {a.shape[axis] // 4}:
            raise AssertionError(f"{name}: shards {[(s.device, s.data.shape) for s in shards]}")
        return f"{name} {a.shape} → 4 shards of {sizes.pop()} on {sorted(d.id for d in devs)}"

    for i, leaf in enumerate(jax.tree.leaves(seen["parts"])):
        print(placement(f"operator part {i}", leaf, 0))
    print(placement("basis V", seen["V"], 1))
    e4 = float(res.eigenvalues[0])
    err = abs(e4 - e1) / abs(e1)
    print(
        f"four cards: E0 {e4:.10f} vs one-card refined {e1:.12f}: rel err {err:.2e}; "
        f"{res.iterations} iterations in {t_mesh:.1f} s ({res.termination})"
    )
    for d in jax.devices():
        print(f"{d}: peak_bytes_in_use {(d.memory_stats() or {}).get('peak_bytes_in_use')}")
    if not err <= 1e-5:
        raise AssertionError(f"four-card E0 rel err {err:.2e} > 1e-5")


def build_operators(ctx, four_cards: bool):
    from eigenex_tpu.sparse.accelerate import accelerate

    t0 = time.perf_counter()
    r, c, v, dim = ctx["trip3"] = heisenberg_triplets(ctx["L"])
    print(f"L={ctx['L']} sector: dim {dim:,}, {len(v):,} nnz, built in {time.perf_counter() - t0:.1f} s")
    acc = ctx["acc3"] = accelerate((r, c, v, (dim, dim)), symmetric=True)
    st = acc.stats
    print(
        f"pack: {st['pack_seconds']:.1f} s, {st['dtype']}, fill {st['fill'] * 100:.2f}%, "
        f"{st['bytes'] / 2**30:.2f} GiB, ku={st.get('ku')} reach={st.get('band_reach')}"
    )
    if four_cards:
        return
    ctx["csr3"] = permuted_csr(acc, r, c, v)
    r2, c2, v2, n2 = ctx["trip2"] = convection_diffusion_triplets(ctx["nx"])
    ctx["acc2"] = accelerate((r2, c2, v2, (n2, n2)))
    ctx["csr2"] = permuted_csr(ctx["acc2"], r2, c2, v2)
    print(f"config 2: n={n2:,}, {len(v2):,} nnz, pack {ctx['acc2'].stats['pack_seconds']:.1f} s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card accelerate= x mesh= eigsh and its comparison")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from eigenex_tpu.utils.benchtime import configure_compile_cache

    configure_compile_cache(ROOT)
    device = run_phase("device", phase_device)
    ctx = dict(L=24, nx=1000, nbr=2048)
    run_phase("operators", build_operators, ctx, args.four_cards)
    if args.four_cards:
        if device["count"] != 4:
            print(f"--four-cards needs 4 devices, JAX sees {device['count']}", flush=True)
            sys.exit(1)
        run_phase("four-cards", phase_four_cards, ctx)
    else:
        run_phase("kernels", phase_kernels, ctx)
        run_phase("eigsh", phase_eigsh, ctx)
        run_phase("eigs", phase_eigs, ctx)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
