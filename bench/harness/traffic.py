"""The one traffic generator: an image pool, the order requests draw from
it, and the arrival times of an open loop, all from the seed and the
cell's parameters.

- Pool: ``pool`` images of the configuration's input shape, fp32 in
  [0, 1), drawn on the card in one call and brought to the host, where
  requests carry them.  Image i is o_i + s_i * u_i: uniform noise u_i
  under a contrast s_i in [0.25, 1) and an offset o_i in [0, 1 - s_i),
  so images differ in their statistics and their outputs differ.
- Order: request k carries pool image ``order[k % len(order)]``, a
  seeded permutation of the pool.
- Arrivals (open loop, ``"arrivals": "poisson"``): n = round(rate *
  seconds) gaps, the exponential distribution's n midpoint quantiles at
  the cell's rate in a seeded order.  Every seed gets the same set of
  gaps, so seeds change the order of the work and not its amount.
"""
from __future__ import annotations

import numpy as np
import torch

from harness import seeds


def pool(seed: int, n: int, shape: tuple, device: torch.device
         ) -> np.ndarray:
    """(n, H, W, C) float32 images in [0, 1) on the host."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.derive(seed, "images"))
    u = torch.rand((n, *shape), generator=gen, device=device)
    s, o = torch.rand((2, n, 1, 1, 1), generator=gen, device=device)
    contrast = 0.25 + 0.75 * s
    images = (1.0 - contrast) * o + contrast * u
    # Rounding can reach 1.0 only at the top of the range; keep [0, 1).
    images = images.clamp_(max=float(np.nextafter(np.float32(1),
                                                   np.float32(0))))
    return images.cpu().numpy()


def order(seed: int, n: int) -> np.ndarray:
    return seeds.rng(seed, "order").permutation(n)


def arrival_offsets(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Seconds from the window's start at which each request is due."""
    n = max(1, round(rate * seconds))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    return np.cumsum(seeds.rng(seed, "arrivals").permutation(gaps))
