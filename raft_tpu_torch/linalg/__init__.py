"""Linear algebra of the port (counterpart of ``raft_tpu/linalg``): the
contraction engine, and the dense layer on torch ops and
``torch.linalg`` (cuBLAS and cuSOLVER on the card) with the keyed
reductions on ``csrc/csr_spmm.cu``."""

from raft_tpu_torch.linalg.blas import (  # noqa: F401
    gemm,
    gemv,
    axpy,
    dot,
    transpose,
    scal,
    mean_squared_error,
)
from raft_tpu_torch.linalg.eltwise import (  # noqa: F401
    add,
    add_scalar,
    subtract,
    subtract_scalar,
    multiply,
    multiply_scalar,
    divide,
    divide_scalar,
    power,
    power_scalar,
    sqrt,
    unary_op,
    write_only_unary_op,
    binary_op,
    ternary_op,
)
from raft_tpu_torch.linalg.map import (  # noqa: F401
    map,
    map_offset,
    map_reduce,
    map_then_reduce,
)
from raft_tpu_torch.linalg.reduce import (  # noqa: F401
    ALONG_ROWS,
    ALONG_COLUMNS,
    reduce,
    coalesced_reduction,
    strided_reduction,
    reduce_rows_by_key,
    reduce_cols_by_key,
)
from raft_tpu_torch.linalg.matrix_vector_op import (  # noqa: F401
    matrix_vector_op,
)
from raft_tpu_torch.linalg.norm import (  # noqa: F401
    L1Norm,
    L2Norm,
    LinfNorm,
    norm,
    row_norm,
    col_norm,
    normalize,
)
from raft_tpu_torch.linalg.eig import eig_dc, eig_jacobi, eig_sel  # noqa: F401
from raft_tpu_torch.linalg.qr import qr_get_q, qr_get_qr  # noqa: F401
from raft_tpu_torch.linalg.svd import (  # noqa: F401
    svd_qr,
    svd_eig,
    svd_jacobi,
    svd_reconstruction,
    evaluate_svd_by_reconstruction,
    rsvd_fixed_rank,
    rsvd_perc,
    randomized_svd,
)
from raft_tpu_torch.linalg.lstsq import (  # noqa: F401
    lstsq_svd_qr,
    lstsq_svd_jacobi,
    lstsq_eig,
    lstsq_qr,
)
from raft_tpu_torch.linalg.cholesky import cholesky_r1_update  # noqa: F401
from raft_tpu_torch.linalg.pca import (  # noqa: F401
    Solver,
    PCAResult,
    TSVDResult,
    IncrementalPCAState,
    pca_fit,
    pca_transform,
    pca_inverse_transform,
    pca_fit_transform,
    pca_partial_fit,
    pca_finalize,
    tsvd_fit,
    tsvd_transform,
    tsvd_inverse_transform,
    tsvd_fit_transform,
    cal_eig,
    sign_flip_components,
)
from raft_tpu_torch.linalg.contractions import (  # noqa: F401
    fused_argmin_pallas,
    fused_l2_argmin_pallas,
    fused_lloyd_pallas,
    fused_lloyd_prepared,
    lloyd_prepare,
    pairwise_l2_pallas,
    pairwise_pallas,
)
