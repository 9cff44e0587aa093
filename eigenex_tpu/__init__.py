"""eigenex_tpu — a JAX Krylov eigensolver and tensor library.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of
``versmc/cmpt-eigenex`` (a serial header-only C++/Eigen extension
library): matrix-free Lanczos/Arnoldi eigensolvers, Krylov f(A)v and
exp(xA)v, COO/CSR/BSR sparse operators with Pallas SpMV kernels, tensor
SVD, multi-index interpretation, string-labeled einsum, block-sparse
tensors with symmetry-sector-aware contraction, and mesh-sharded
distributed execution — none of it a port: the compute path is built
for accelerator matrix units and XLA's compilation model.
"""

from .block.block_tensor import BlockTensor, block_tensor_norm, block_tensor_squared_norm
from .core.dtensor import DTensor, dtensor
from .core.indices import AddIndices, ProductIndices, Slice
from .core.operators import LinearOperator, aslinearoperator, identity_operator
from .ops.orthogonalize import (
    cgs2,
    gram_schmidt,
    orthogonal_complement,
    project_out,
)
from .ops.einsum import contract, einsum
from .ops.kron import TensorKroneckerProduct, tensor_kronecker_product
from .ops.tensor_svd import TensorSVDResult, tensor_svd, truncated_tensor_svd
from .ops.tensor_util import (
    contract_vector_as_diagonal,
    transform_tensor_with_matrix,
    zerowisely_resized,
)
from .block.hamiltonians import (
    heisenberg_block_hamiltonian,
    heisenberg_ground_state,
    heisenberg_sector_coo,
)
from .ops.sparse_svd import gram_operator, truncated_svd_via_lanczos
from .parallel import (
    DistributedLanczosEigenSolver,
    DistributedThickRestartLanczosEigenSolver,
    distributed_lanczos_steps,
    initialize_multihost,
    make_mesh,
    pad_bsr_for_mesh,
)
from .solvers.gmres import gmres_solve, gmres_solve_jit, shift_invert_operator_general
from .solvers.api import eigs, eigsh, svds
from .sparse.accelerate import AcceleratedOperator, accelerate
from .solvers.krylov_schur import KrylovSchurArnoldiSolver, KrylovSchurOptions
from .solvers.arnoldi import ArnoldiEigenSolver, ArnoldiOptions, ArnoldiResult
from .solvers.cg import cg_solve, cgls_solve, minres_solve, shift_invert_operator
from .solvers.block_lanczos import BlockLanczosEigenSolver, BlockLanczosOptions
from .solvers.chebyshev import (
    ChebyshevFilterOptions,
    ChebyshevFilterSolver,
    chebyshev_bandpass_apply,
    chebyshev_filter_apply,
    eigsh_window,
)
from .solvers.kpm import (
    chebyshev_moments,
    eigenvalue_count,
    eigsh_range,
    spectral_density,
)
from .solvers.lobpcg import LOBPCGOptions, LOBPCGSolver, lobpcg
from .solvers.precond import jacobi_preconditioner
from .solvers.refine import (
    general_inverse_iteration_refine,
    general_rayleigh_refine,
    inverse_iteration_refine,
    rayleigh_refine,
)
from .solvers.restart import ThickRestartLanczosEigenSolver, ThickRestartOptions
from .sparse.realify import (
    complex_from_real,
    dedup_doubled_eigenvalues,
    eigs_realified,
    real_from_complex,
    realify_coo,
)
from .utils.checkpoint import load_state, save_state, shard_state
from .solvers.functions import (
    LanczosExponentialSolver,
    LanczosFunctionSolver,
    expm_multiply,
    lanczos_expmv,
    lanczos_function_apply,
    taylor_expmv,
    taylor_expmv_auto,
)
from .sparse import (
    BSRMatrix,
    COOBuilder,
    COOMatrix,
    CSRMatrix,
    SymBSRMatrix,
    bsr_from_coo_arrays,
    bsr_from_dense,
    coo_from_dense,
    coo_identity,
    csr_from_coo,
    csr_from_dense,
    load_matrix_market,
    save_matrix_market,
    sym_bsr_from_bsr,
)
from .solvers.lanczos import (
    UNLIMITED,
    LanczosEigenSolver,
    LanczosOptions,
    LanczosResult,
    LanczosState,
    init_lanczos_state,
    lanczos_steps,
)
from .utils.exceptions import (
    ArnoldiError,
    BlockTensorError,
    EigenexError,
    EinsumError,
    LanczosError,
    OperatorError,
)
from .utils.prng import (
    random_hermitian,
    random_matrix,
    random_normal,
    random_orthogonal,
    random_tensor,
    random_uniform,
    random_vector,
)
from .utils.tolerance import default_tolerance
from .utils.trace import ConvergenceTrace

__version__ = "0.1.0"
