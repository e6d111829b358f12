"""The PyTorch port's count-min sketch against the JAX package, on the CPU.

Tolerance: none.  ``cms_update`` and ``cms_query`` equal the reference's
bit for bit, for unit weights and for float weights.  XLA on the CPU adds
a cell's updates one after another in item order; the port folds each
cell's weights in item order on every device, so float weights whose sum
depends on the order (several magnitudes on one heavy-hitter slot) give
the same bits.  ``test_cms_float_sums_depend_on_the_order`` shows that
these inputs do tell the orders apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.signature import CountMinSketch as JaxCountMinSketch
from repro.core.signature import cms_init as jax_cms_init
from repro.core.signature import cms_query as jax_cms_query
from repro.core.signature import cms_update as jax_cms_update
from repro_torch.core.signature import (
    CountMinSketch,
    _cms_slots,
    cms_init,
    cms_query,
    cms_update,
)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _zipf_items(seed=6, n=5000):
    """tests/test_core.py's stream: zipf(1.5) items folded into 1,000."""
    rng = np.random.default_rng(seed)
    return rng.zipf(1.5, n).astype(np.int32) % 1000


def _heavy(seed, n=4000, hot=7, distinct=50):
    """Most items on one hot id, weights over six orders of magnitude, so
    a cell's float sum depends on the order of its updates."""
    rng = np.random.default_rng(seed)
    items = np.concatenate([
        np.full(n // 2, hot, np.int32),
        rng.integers(0, distinct, n - n // 2).astype(np.int32),
    ])
    rng.shuffle(items)
    w = (rng.standard_normal(n)
         * rng.choice([1e-3, 1.0, 1e3], n)).astype(np.float32)
    return items, w


def _both(depth, width, items, weights=None, start=None):
    """(JAX sketch, port sketch) after one update from ``start``."""
    if start is None:
        js, ps = jax_cms_init(depth, width), cms_init(depth, width, device="cpu")
    else:
        js = JaxCountMinSketch(jnp.asarray(start))
        ps = CountMinSketch(torch.from_numpy(start.copy()))
    jw = None if weights is None else jnp.asarray(weights)
    pw = None if weights is None else torch.from_numpy(weights)
    return (jax_cms_update(js, jnp.asarray(items), jw),
            cms_update(ps, torch.from_numpy(items), pw))


@pytest.mark.parametrize("depth,width", [(4, 2048), (3, 64), (1, 1), (5, 1000)])
def test_cms_unit_weights_match_jax(depth, width):
    items = _zipf_items()
    js, ps = _both(depth, width, items)
    np.testing.assert_array_equal(_bits(js.counts), _bits(ps.counts))
    uniq = np.unique(items)
    np.testing.assert_array_equal(
        _bits(jax_cms_query(js, jnp.asarray(uniq))),
        _bits(cms_query(ps, torch.from_numpy(uniq))),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("width", [16, 1024])
def test_cms_float_weights_heavy_hitters_match_jax(seed, width):
    items, w = _heavy(seed)
    # from a sketch already holding non-integer counts
    start = np.asarray(_both(4, width, items[::3], w[::3])[0].counts)
    js, ps = _both(4, width, items, w, start=start)
    np.testing.assert_array_equal(_bits(js.counts), _bits(ps.counts))
    probe = np.arange(-3, 60, dtype=np.int32)
    np.testing.assert_array_equal(
        _bits(jax_cms_query(js, jnp.asarray(probe))),
        _bits(cms_query(ps, torch.from_numpy(probe))),
    )


def test_cms_float_sums_depend_on_the_order():
    """The heavy-hitter inputs above do tell two add orders apart: a
    scatter-add in reverse item order lands on other bits than the
    reference, which the port's per-cell item-order fold matches."""
    items, w = _heavy(0)
    depth, width = 4, 16
    want = np.asarray(_both(depth, width, items, w)[0].counts).reshape(-1)
    slots = _cms_slots(torch.from_numpy(items), depth, width)
    cell = (slots + width * torch.arange(depth)[:, None]).reshape(-1)
    flat_w = torch.from_numpy(w).expand(depth, -1).reshape(-1)
    rev = torch.zeros(depth * width).index_add_(0, cell.flip(0), flat_w.flip(0))
    assert not np.array_equal(_bits(rev.numpy()), _bits(want))
    seq = np.zeros(depth * width, np.float32)
    for c, x in zip(cell.tolist(), flat_w.numpy()):
        seq[c] = np.float32(seq[c] + x)
    np.testing.assert_array_equal(_bits(seq), _bits(want))


def test_cms_empty_update_matches_jax():
    items, w = _heavy(3, n=600)
    start = np.asarray(_both(3, 32, items, w)[0].counts)
    je, pe = _both(3, 32, np.zeros(0, np.int32), start=start)
    np.testing.assert_array_equal(_bits(je.counts), _bits(pe.counts))
    np.testing.assert_array_equal(_bits(pe.counts), _bits(start))


def test_cms_overestimates_bounded():
    """tests/test_core.py's property on the port: never under the true
    count, a small overestimate on average."""
    items = _zipf_items()
    sk = cms_update(cms_init(4, 2048, device="cpu"), torch.from_numpy(items))
    uniq, counts = np.unique(items, return_counts=True)
    est = cms_query(sk, torch.from_numpy(uniq)).numpy()
    assert (est >= counts - 1e-5).all()
    assert (est - counts).mean() < 30


def test_cms_init_needs_the_gpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU behaviour")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cms_init()
    sk = cms_init(2, 8, device="cpu")
    assert sk.counts.shape == (2, 8) and sk.counts.dtype == torch.float32
