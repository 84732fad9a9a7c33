"""The port's hand-written CUDA kernels: K1 (``mcf_inverse``) and K2
(``mcf_unit_inverse``).  Each launch of either adds one to its counter in
``utils/profiling``: ``mcf.k1_launches``, ``mcf.k2_launches``."""
from ipoke_tpu_torch.utils import profiling

COUNTERS = {"mcf_inverse": "mcf.k1_launches", "macow_unit_inverse": "mcf.k2_launches"}


def launches_since(before):
    """K1's and K2's launches since ``before``, a ``profiling.counts()``
    snapshot: {"mcf_inverse": n, "macow_unit_inverse": n}."""
    now = profiling.counts()
    return {k: now.get(c, 0) - before.get(c, 0) for k, c in COUNTERS.items()}
