"""Random distribution generators (counterpart of ``raft_tpu/random/rng.py``).

Every function takes ``(res, state, shape, ...)`` and returns a fresh
tensor on the handle's device (``cuda:0`` by default). Each call that
draws takes one generator from ``state.next_key`` (torch's Philox on the
card), so ``state.base_subsequence`` advances exactly as the reference's
does; ``fill`` draws nothing and does not advance, as there. The
contract is the reference's distribution, shape, dtype and range, not
its bits (ROADMAP.md, queue C, "RNG streams differ").

``sample`` with replacement draws by inverse CDF (a cumulative sum and a
binary search), so it has no cap on the number of categories;
``torch.multinomial`` stops at 2^24. Sampling without replacement keeps
the reference's Gumbel-top-k design, its top-k taken by
:func:`raft_tpu_torch.matrix.select_k` (the radix kernels where its
dispatch picks them).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

# the module, not its names: core.resources imports this package
from raft_tpu_torch.core import resources
from raft_tpu_torch.random.rng_state import RngState

Shape = Union[int, Sequence[int]]

__all__ = ["uniform", "uniform_int", "normal", "normal_int", "normal_table",
           "fill", "bernoulli", "scaled_bernoulli", "gumbel", "laplace",
           "logistic", "lognormal", "rayleigh", "exponential", "sample",
           "sample_without_replacement", "excess_subsample"]


def _shape(shape: Shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _device(res) -> torch.device:
    return resources.default_resources(res).device


def _draw(res, state: RngState):
    """``(generator, device)`` for one call: the call's key."""
    dev = _device(res)
    return state.next_key(dev), dev


def _open_unit(res, state: RngState, shape: Shape, dtype):
    """U[tiny, 1) in ``dtype`` (the reference's minval=tiny draws): no
    zero, so its logarithm is finite."""
    g, dev = _draw(res, state)
    u = torch.rand(_shape(shape), generator=g, dtype=dtype, device=dev)
    return u.clamp_min_(torch.finfo(dtype).tiny)


def uniform(res, state: RngState, shape: Shape, low=0.0, high=1.0,
            dtype=torch.float32):
    """U[low, high): a draw that rounds up to ``high`` is moved to the
    largest value below it."""
    g, dev = _draw(res, state)
    u = torch.empty(_shape(shape), dtype=dtype, device=dev)
    u.uniform_(low, high, generator=g)
    top = torch.nextafter(torch.tensor(high, dtype=dtype, device=dev),
                          torch.tensor(low, dtype=dtype, device=dev))
    return torch.minimum(u, top) if high > low else u


def uniform_int(res, state: RngState, shape: Shape, low: int, high: int,
                dtype=torch.int32):
    """Integers in [low, high)."""
    g, dev = _draw(res, state)
    return torch.randint(int(low), int(high), _shape(shape), generator=g,
                         dtype=dtype, device=dev)


def normal(res, state: RngState, shape: Shape, mu=0.0, sigma=1.0,
           dtype=torch.float32):
    g, dev = _draw(res, state)
    return torch.randn(_shape(shape), generator=g, dtype=dtype,
                       device=dev) * sigma + mu


def normal_int(res, state: RngState, shape: Shape, mu: int, sigma: int,
               dtype=torch.int32):
    """A normal in f32, rounded half to even."""
    g, dev = _draw(res, state)
    vals = torch.randn(_shape(shape), generator=g, dtype=torch.float32,
                       device=dev) * sigma + mu
    return torch.round(vals).to(dtype)


def normal_table(res, state: RngState, n_rows: int, mu_vec, sigma_vec,
                 dtype=torch.float32):
    """[n_rows, len(mu_vec)]: column j is N(mu_vec[j], sigma_vec[j])."""
    dev = _device(res)
    mu = torch.as_tensor(mu_vec, dtype=dtype, device=dev)
    sigma = torch.as_tensor(sigma_vec, dtype=dtype, device=dev)
    g = state.next_key(dev)
    z = torch.randn((int(n_rows), mu.shape[0]), generator=g, dtype=dtype,
                    device=dev)
    return z * sigma[None, :] + mu[None, :]


def fill(res, state: RngState, shape: Shape, value, dtype=torch.float32):
    """A constant; draws nothing, so the state stays where it is."""
    return torch.full(_shape(shape), value, dtype=dtype, device=_device(res))


def bernoulli(res, state: RngState, shape: Shape, prob: float):
    """Booleans, True with probability ``prob``."""
    g, dev = _draw(res, state)
    return torch.rand(_shape(shape), generator=g, device=dev) < prob


def scaled_bernoulli(res, state: RngState, shape: Shape, prob: float,
                     scale: float, dtype=torch.float32):
    """-scale with probability ``prob``, else +scale."""
    b = bernoulli(res, state, shape, prob)
    pos = torch.tensor(scale, dtype=dtype, device=b.device)
    return torch.where(b, -pos, pos)


def gumbel(res, state: RngState, shape: Shape, mu=0.0, beta=1.0,
           dtype=torch.float32):
    u = _open_unit(res, state, shape, dtype)
    return -torch.log(-torch.log(u)) * beta + mu


def laplace(res, state: RngState, shape: Shape, mu=0.0, scale=1.0,
            dtype=torch.float32):
    """Inverse CDF of u in (-1, 1)."""
    g, dev = _draw(res, state)
    u = torch.empty(_shape(shape), dtype=dtype, device=dev)
    u.uniform_(-1.0, 1.0, generator=g)
    lo = torch.nextafter(torch.tensor(-1.0, dtype=dtype, device=dev),
                         torch.tensor(0.0, dtype=dtype, device=dev))
    u = torch.maximum(u, lo)
    return -torch.sign(u) * torch.log1p(-u.abs()) * scale + mu


def logistic(res, state: RngState, shape: Shape, mu=0.0, scale=1.0,
             dtype=torch.float32):
    u = _open_unit(res, state, shape, dtype)
    return (torch.log(u) - torch.log1p(-u)) * scale + mu


def lognormal(res, state: RngState, shape: Shape, mu=0.0, sigma=1.0,
              dtype=torch.float32):
    g, dev = _draw(res, state)
    z = torch.randn(_shape(shape), generator=g, dtype=dtype, device=dev)
    return torch.exp(z * sigma + mu)


def rayleigh(res, state: RngState, shape: Shape, sigma=1.0,
             dtype=torch.float32):
    u = _open_unit(res, state, shape, dtype)
    return sigma * torch.sqrt(-2.0 * torch.log(u))


def exponential(res, state: RngState, shape: Shape, lam=1.0,
                dtype=torch.float32):
    """-log1p(-u) / lam over u in [0, 1)."""
    g, dev = _draw(res, state)
    u = torch.rand(_shape(shape), generator=g, dtype=dtype, device=dev)
    return -torch.log1p(-u) / lam


def sample(res, state: RngState, n_samples: int, weights,
           replace: bool = True, dtype=torch.int32):
    """Weighted discrete draws (the reference's ``discrete``): indices
    into ``weights``. With replacement by inverse CDF in f64 (a
    zero-weight category is never drawn; any number of categories);
    without, as :func:`sample_without_replacement`."""
    dev = _device(res)
    w = torch.as_tensor(weights, device=dev)
    if not replace:
        return sample_without_replacement(res, state, n_samples, weights=w,
                                          dtype=dtype)
    cdf = torch.cumsum(w.to(torch.float64), 0)
    cdf = cdf / cdf[-1]                      # the last is 1.0 exactly
    g = state.next_key(dev)
    u = torch.rand(int(n_samples), generator=g, dtype=torch.float64,
                   device=dev)
    return torch.searchsorted(cdf, u, right=True).to(dtype)


def sample_without_replacement(res, state: RngState, n_samples: int,
                               weights=None, pool_size: Optional[int] = None,
                               dtype=torch.int32):
    """Weighted sampling without replacement by the Gumbel-top-k trick:
    the ``n_samples`` largest ``log(w) + G``, in descending key order;
    a weight of 0 is taken as the smallest normal f32."""
    dev = _device(res)
    if weights is None:
        if pool_size is None:
            raise ValueError("need weights or pool_size")
        logits = torch.zeros(int(pool_size), dtype=torch.float32, device=dev)
    else:
        w = torch.as_tensor(weights, device=dev).to(torch.float32)
        logits = torch.log(w.clamp_min(torch.finfo(torch.float32).tiny))
        pool_size = w.shape[0]
    if n_samples > pool_size:
        raise ValueError("n_samples exceeds pool size")
    from raft_tpu_torch.matrix.select_k import select_k

    u = torch.rand(logits.shape, generator=state.next_key(dev),
                   dtype=torch.float32, device=dev)
    u.clamp_min_(torch.finfo(torch.float32).tiny)
    key = logits - torch.log(-torch.log(u))          # logits + Gumbel
    _, idx = select_k(res, key[None, :], int(n_samples), select_min=False)
    return idx[0].to(dtype)


def excess_subsample(res, state: RngState, n_samples: int, pool_size: int,
                     dtype=torch.int32):
    """A uniform subsample of [0, pool_size) without replacement."""
    return sample_without_replacement(res, state, n_samples,
                                      pool_size=pool_size, dtype=dtype)
