"""``repro_torch.core.metrics`` (ARI, AMI and their parts, host numpy)
against ``repro.core.metrics`` on the same seeded labelings, to 1e-12."""

import numpy as np
import pytest

from repro.core import metrics as jm
from repro_torch.core import metrics as tm


def _labelings(seed, n, k):
    """A DBSCAN-like labeling (noise -1, clusters 0..k-1) and a perturbed copy."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-1, k, n)
    b = a.copy()
    flip = rng.random(n) < 0.2
    b[flip] = rng.integers(-1, k + 2, int(flip.sum()))
    return a, b


@pytest.mark.parametrize("seed,n,k", [(0, 50, 3), (1, 400, 12), (2, 1000, 40), (3, 7, 1)])
def test_scores_match_reference(seed, n, k):
    a, b = _labelings(seed, n, k)
    for fn in ("adjusted_rand_index", "adjusted_mutual_info", "mutual_info"):
        got, want = getattr(tm, fn)(a, b), getattr(jm, fn)(a, b)
        assert abs(got - want) <= 1e-12, (fn, got, want)
    m_t, ra_t, cb_t = tm.contingency(a, b)
    m_j, ra_j, cb_j = jm.contingency(a, b)
    for x, y in ((m_t, m_j), (ra_t, ra_j), (cb_t, cb_j)):
        np.testing.assert_array_equal(x, y)
    assert abs(tm.entropy(ra_t) - jm.entropy(ra_j)) <= 1e-12
    assert abs(tm.expected_mutual_info(ra_t, cb_t) - jm.expected_mutual_info(ra_j, cb_j)) <= 1e-12


def test_degenerate_labelings_match_reference():
    same = np.array([0, 0, 1, 1, -1])
    one = np.zeros(5, dtype=np.int64)
    for a, b in [(same, same), (one, one), (one, same), (same, same[::-1])]:
        assert tm.adjusted_rand_index(a, b) == jm.adjusted_rand_index(a, b)
        assert tm.adjusted_mutual_info(a, b) == jm.adjusted_mutual_info(a, b)
    assert tm.adjusted_rand_index(same, same) == 1.0
    with pytest.raises(ValueError):
        tm.contingency(same, same[:3])
