"""The port's optimizers and FedAvg against the JAX package's.

On seeded leaves and gradients: five Adam steps within 1e-6 (the same
fp32 operations, which XLA may fuse); eight steps of SGD bit-equal (a
multiply and a subtract per element), of AdamW within 1e-6 relative and
1e-6 absolute, and of Adafactor within 1e-5 relative and 1e-6 absolute
(the largest difference found is 2.4e-7 absolute: the row and column
means add in another order, one ulp each); FedAvg bit-equal (the same
float32 numpy arithmetic).  Adafactor's factored state has the JAX
shapes, and a rank-3 leaf updates one leading slice at a time."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fedsvc.aggregation import fedavg_leaves as jfedavg
from repro.optim import optimizer as jopt_mod
from repro.optim.optimizer import adam as jadam
from repro_torch import optim as topt_mod
from repro_torch.fedsvc import fedavg_leaves as tfedavg
from repro_torch.optim import adafactor as tadafactor
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


RANK3 = SHAPES + [(3, 8, 16)]


def _leaves3(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in RANK3]


@pytest.mark.parametrize("name,args,kw,rtol,atol", [
    ("sgd", (0.05,), {}, 0, 0),
    ("sgd", (0.05,), {"momentum": 0.9}, 0, 0),
    ("adamw", (1e-2,), {}, 1e-6, 1e-6),
    ("adam", (1e-2,), {"weight_decay": 0.1}, 1e-6, 1e-6),
    ("adafactor", (1e-2,), {}, 1e-5, 1e-6),
    ("adafactor", (1e-2,), {"clip_threshold": 0.05, "decay": 0.5},
     1e-5, 1e-6),
])
def test_optimizers_match_jax(name, args, kw, rtol, atol):
    jopt = getattr(jopt_mod, name)(*args, **kw)
    topt = getattr(topt_mod, name)(*args, **kw)
    assert jopt.name == topt.name
    jp = [jnp.asarray(a) for a in _leaves3(0)]
    tp = [torch.from_numpy(a) for a in _leaves3(0)]
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(8):
        g = _leaves3(20 + step, scale=10.0 ** -(step % 4))
        jp, js = jopt.step(jp, [jnp.asarray(a) for a in g], js)
        tp, ts = topt.step(tp, [torch.from_numpy(a) for a in g], ts)
        for a, b in zip(jp, tp):
            assert b.dtype == torch.float32 and not b.requires_grad
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                       atol=atol)
    if name == "sgd" and kw:
        for a, b in zip(js, ts):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    if name == "adafactor":
        for a, b in zip(js.vr + js.vc, ts.vr + ts.vc):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-30)
        assert int(ts.count) == int(js.count) == 8


def test_adafactor_state_is_factored():
    """The JAX package's factored-state shapes
    (``tests/test_optim.py``)."""
    params = [torch.ones((64, 128)), torch.zeros((128,)),
              torch.ones((4, 32, 16))]
    st = tadafactor(1e-2).init(params)
    assert [tuple(v.shape) for v in st.vr] == [(64,), (128,), (4, 32)]
    assert [tuple(v.shape) for v in st.vc] == [(128,), (), (4, 16)]
    pn = sum(p.numel() for p in params)
    sn = sum(v.numel() for v in st.vr + st.vc)
    assert sn < 0.1 * pn


def test_adafactor_rank3_equals_slice_by_slice():
    """A rank-3 leaf updates each leading slice as a leaf of its own
    (``lax.map`` in the JAX package): bit-equal here, where both run the
    same operations per slice."""
    opt = tadafactor(1e-2)
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((3, 8, 16)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((3, 8, 16)).astype(np.float32))
    (new,), st = opt.step([w], [g], opt.init([w]))
    for i in range(3):
        (ni,), sti = opt.step([w[i]], [g[i]], opt.init([w[i]]))
        assert torch.equal(new[i], ni)
        assert torch.equal(st.vr[0][i], sti.vr[0])
        assert torch.equal(st.vc[0][i], sti.vc[0])
