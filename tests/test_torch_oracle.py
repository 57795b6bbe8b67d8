"""The unfused oracle K13 against the fused streamed schedule, on clusters.

K13 (``streamed-2pass``) runs each routing pass after the first as a
b-pass (the logits update alone) and an s-pass; the fused K4/K9 fold the
update into the s-pass.  On the cluster core both make the same sums in
the same order, so their plain twins (``cluster_routing_plain``,
``votes_routing_bwd_plain``) must agree bit for bit at every cluster
size, forward and backward, as the reference's two schedules do.  The
comparisons with the JAX reference are in ``tests/test_torch_stack.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.execplan import ORACLE_MODE
from repro_torch.kernels import votes_routing as vr

# The reference's cases (tests/test_votes_routing.py, tests/test_grads.py):
# (batch, I, C, J, D, block_i, iters).
CASES = {"even": (1, 64, 8, 10, 16, 32, 3),
         "ragged": (2, 100, 8, 10, 16, 32, 3),
         "nonpow2": (2, 27, 4, 4, 8, 8, 1)}


def _inputs(case: str):
    b, i, c, j, d, bi, iters = CASES[case]
    rng = np.random.default_rng(i + iters)
    u = torch.from_numpy(0.5 * rng.standard_normal((b, i, c), np.float32))
    w = torch.from_numpy(0.3 * rng.standard_normal((i, j * d, c),
                                                   np.float32))
    g = torch.from_numpy(rng.standard_normal((b, j * d), np.float32))
    return u, w, g, dict(iters=iters, num_classes=j, block_i=bi)


@pytest.mark.parametrize("cs", [1, 2, 4, 16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_oracle_forward_twin_is_the_fused_twin(case, cs):
    u, w, _, kw = _inputs(case)
    torch.testing.assert_close(
        vr.cluster_routing_plain(u, w, mode=ORACLE_MODE, cluster=cs, **kw),
        vr.cluster_routing_plain(u, w, mode="streamed", cluster=cs, **kw),
        rtol=0, atol=0)


@pytest.mark.parametrize("cs", [1, 2, 4, 16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_oracle_backward_twin_is_the_fused_twin(case, cs):
    u, w, g, kw = _inputs(case)
    got = vr.votes_routing_bwd_plain(u, w, g, mode=ORACLE_MODE, cluster=cs,
                                     **kw)
    want = vr.votes_routing_bwd_plain(u, w, g, mode="streamed", cluster=cs,
                                      **kw)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
