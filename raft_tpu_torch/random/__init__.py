"""Random state and generators of the port (counterpart of
``raft_tpu/random``)."""

from raft_tpu_torch.random.rng_state import (  # noqa: F401
    GeneratorType, RngState)
from raft_tpu_torch.random.rng import (  # noqa: F401
    uniform,
    uniform_int,
    normal,
    normal_int,
    normal_table,
    fill,
    bernoulli,
    scaled_bernoulli,
    gumbel,
    laplace,
    logistic,
    lognormal,
    rayleigh,
    exponential,
    sample,
    sample_without_replacement,
    excess_subsample,
)
from raft_tpu_torch.random.make_blobs import make_blobs  # noqa: F401
from raft_tpu_torch.random.make_regression import (  # noqa: F401
    make_regression)
from raft_tpu_torch.random.permute import permute, permute_rows  # noqa: F401
from raft_tpu_torch.random.multi_variable_gaussian import (  # noqa: F401
    multi_variable_gaussian,
    Decomposer,
)
from raft_tpu_torch.random.rmat import rmat_rectangular_gen  # noqa: F401

# the reference's spelling (rng.cuh `discrete`: a weighted discrete draw)
from raft_tpu_torch.random.rng import sample as discrete  # noqa: F401,E402
