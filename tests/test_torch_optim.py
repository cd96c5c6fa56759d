"""The port's Adam and FedAvg against the JAX package's: five Adam steps
on JAX-seeded leaves within 1e-6 (the same fp32 operations, which XLA
may fuse), and FedAvg bit-equal (the same float32 numpy arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fedsvc.aggregation import fedavg_leaves as jfedavg
from repro.optim.optimizer import adam as jadam
from repro_torch.fedsvc import fedavg_leaves as tfedavg
from repro_torch.optim import adam as tadam

torch.set_num_threads(1)

SHAPES = [(16,), (64, 16), (16,), (16, 16), (40,), (16, 40)]


def _leaves(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in SHAPES]


@pytest.mark.parametrize("lr", [1e-2, 3e-4])
def test_adam_matches_jax(lr):
    jopt, topt = jadam(lr), tadam(lr)
    jp = [jnp.asarray(a) for a in _leaves(0)]
    tp = [torch.from_numpy(a) for a in _leaves(0)]
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        g = _leaves(10 + step, scale=10.0 ** -step)
        jp, js = jopt.step(jp, [jnp.asarray(a) for a in g], js)
        tp, ts = topt.step(tp, [torch.from_numpy(a) for a in g], ts)
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-6)
        for a, b in zip(js.nu, ts.nu):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-12)
    assert int(ts.count) == int(js.count) == 5
    assert all(t.dtype == torch.float32 for t in tp)


def test_fedavg_bit_equal():
    clients = [_leaves(s) for s in range(4)]
    weights = [3000.0, 17.0, 801.0, 5.0]
    for a, b in zip(jfedavg(clients, weights), tfedavg(clients, weights)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tfedavg(clients, weights[:2])
