"""The general traffic generator: a traffic mix's parameters -> inputs.

A traffic mix (`traffic/<name>.json`) is data only. This module makes
its inputs from the run's seed, on the host, so that the same seed gives
the same inputs and the program receives only what is generated here:

  * `pool` clouds, each a fresh `room_cloud` draw of the configuration's
    `n_points` (or the mix's `points`) with its own seed derived from the
    run's seed and its index; every seed gets the same sizes.

Requests are closed-loop: each starts when the previous one has finished,
and request i takes pool input i mod pool.
"""

from __future__ import annotations

import numpy as np

from portbench.harness import synthetic


def item_seed(seed: int, index: int) -> int:
    """The seed of pool input `index` of a run seeded `seed` (any whole
    number; negative and large seeds are taken modulo 2**64)."""
    ss = np.random.SeedSequence([seed % (1 << 64), index])
    return int(ss.generate_state(1, np.uint64)[0])


def make_pool(traffic: dict, config: dict, seed: int) -> dict:
    """{"points": [pool] float32 [N, 3], "colors": [pool] float32 [N, 3]}."""
    n = int(traffic.get("points", config["n_points"]))
    k = int(traffic["pool"])
    clouds = [synthetic.room_cloud(n, seed=item_seed(seed, i))
              for i in range(k)]
    return {"points": [c[0] for c in clouds],
            "colors": [c[1] for c in clouds]}
