"""Matrix primitives of the port (counterpart of ``raft_tpu/matrix``):
batched top-k selection, per-row argmin/argmax, row gather and scatter,
the linewise broadcast and the dense utilities of ``matrix.ops``."""

from raft_tpu_torch.matrix.epilogue import argmax, argmin  # noqa: F401
from raft_tpu_torch.matrix.gather import (gather, gather_if,  # noqa: F401
                                          scatter, take_rows)
from raft_tpu_torch.matrix.select_k import SelectAlgo, select_k  # noqa: F401
from raft_tpu_torch.matrix.linewise_op import linewise_op  # noqa: F401
from raft_tpu_torch.matrix.ops import (  # noqa: F401
    copy,
    get_diagonal,
    set_diagonal,
    invert_diagonal,
    eye,
    fill,
    linspace,
    l2_norm,
    weighted_power,
    power,
    ratio,
    reciprocal,
    col_reverse,
    row_reverse,
    sign_flip,
    slice,
    sqrt,
    zero_small_values,
    upper_triangular,
    lower_triangular,
    SHIFT_TOWARDS_END,
    SHIFT_TOWARDS_BEGINNING,
    col_shift,
    row_shift,
    sort_cols_per_row,
    sample_rows,
    print_matrix,
)

# the reference's spellings, one a public header of raft/matrix/
col_wise_sort = sort_cols_per_row
diagonal = get_diagonal
norm = l2_norm
reverse = row_reverse
shift = row_shift
threshold = zero_small_values
triangular = upper_triangular
