"""Seeded vectors with SIFT's width: a non-negative, overlapping mixture
on a low-dimensional manifold.

The real ``sift-128-euclidean`` files cannot be read here, so a
configuration's ``data`` block describes a stand-in (all of it listed
under ``assumed`` in the configuration's file). SIFT descriptors are
non-negative, normalised to about 512 and of low intrinsic dimension, so
a row is made as

- a latent point: one of ``components`` centres ``center_scale *
  N(0, I_latent)``, picked with weights ``softmax(weight_sigma *
  N(0, 1))`` (so lists come out uneven), plus ``noise * N(0, I_latent)``;
- mapped to ``dim`` by a fixed random ``latent_dim x dim`` matrix of
  ``N(0, 1 / latent_dim)`` entries, shifted by ``center_mean``, plus
  ``iso_noise * N(0, I_dim)``;
- clipped at 0 and scaled to the norm ``norm``.

The centres, the weights, the map and the base rows come from the
configuration's ``mixture_seed`` and ``base_seed``: one fixed database,
as a published data set is. The queries are drawn from the same mixture
with the run's seed. Everything is made on the device in a few calls.
"""

from __future__ import annotations

import math

import torch

_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1


def derive_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for ``stream`` of ``seed`` (any whole
    number, however large)."""
    return ((int(seed) * _MIX) ^ (int(stream) * 0xBF58476D1CE4E5B9)) & _MASK


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _structure(spec: dict, device):
    g = _generator(device, derive_seed(spec["mixture_seed"], 1))
    m, lat, d = int(spec["components"]), int(spec["latent_dim"]), \
        int(spec["dim"])
    centres = spec["center_scale"] * torch.randn(m, lat, generator=g,
                                                 device=device)
    logits = spec["weight_sigma"] * torch.randn(m, generator=g,
                                                device=device)
    lift = torch.randn(lat, d, generator=g, device=device) / math.sqrt(lat)
    return centres, torch.softmax(logits, 0), lift


def draw(spec: dict, n: int, seed: int, device) -> torch.Tensor:
    """``n`` rows [n, dim] float32 of the mixture, drawn with ``seed``."""
    centres, weights, lift = _structure(spec, device)
    g = _generator(device, derive_seed(seed, 2))
    which = torch.multinomial(weights, n, replacement=True, generator=g)
    z = centres[which]
    z.add_(spec["noise"] * torch.randn(z.shape, generator=g, device=device))
    x = torch.addmm(torch.full((1, lift.shape[1]), float(spec["center_mean"]),
                               device=device), z, lift)
    x.add_(spec["iso_noise"] * torch.randn(x.shape, generator=g,
                                           device=device))
    x.relu_()
    norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    x.mul_(spec["norm"] / norms.clamp_min(1e-12))
    return x


def base(spec: dict, n: int, device) -> torch.Tensor:
    """The configuration's database rows (fixed by ``base_seed``)."""
    return draw(spec, n, derive_seed(spec["base_seed"], 3), device)


def queries(spec: dict, n: int, seed: int, device) -> torch.Tensor:
    """The run's query set: ``n`` rows of the mixture from ``seed``."""
    return draw(spec, n, derive_seed(seed, 4), device)
