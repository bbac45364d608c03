"""The port's optimizers against ``repro.optim.optimizers``: the cosine
schedule at its warmup, middle and end steps, Adam and SGD with a
callable learning rate on (K, d) stacks, and the per-row learning rate of
a lane group against the rows' scalar runs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch.optim import optimizers as topt
from repro_torch.optim import adam, cosine_schedule, get_optimizer, sgd


@pytest.mark.parametrize("warmup, total", [(10, 100), (0, 50), (5, 5)])
def test_cosine_schedule_matches_reference(warmup, total):
    """Float32 as the reference computes it under jit: warmup, its edge,
    the middle and the end (and past it, where the cosine is clipped)."""
    ours = cosine_schedule(3e-4, warmup, total, min_frac=0.1)
    ref = jax.jit(jopt.cosine_schedule(3e-4, warmup, total, min_frac=0.1))
    steps = sorted({0, 1, warmup // 2, warmup, warmup + 1,
                    (warmup + total) // 2, total - 1, total, total + 7})
    for s in steps:
        want = float(ref(jnp.int32(s)))
        got = ours(s)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0,
                                   err_msg=f"step {s}")
    batch = ours(torch.tensor(steps, dtype=torch.int32))
    np.testing.assert_allclose(
        batch.numpy(), [float(ref(jnp.int32(s))) for s in steps], rtol=1e-6)


def _jax_steps(opt, theta, grads):
    state = jax.vmap(opt.init)(theta)
    for g in grads:
        theta, state = jax.vmap(opt.update)(g, state, theta)
    return np.asarray(theta)


def _port_steps(opt, theta, grads):
    state = opt.init(theta)
    for g in grads:
        theta, state = opt.update(g, state, theta)
    return theta.numpy()


@pytest.mark.parametrize("name", ["adam", "sgd(momentum=0.9)"])
def test_callable_lr_matches_reference(name):
    """Adam evaluates ``lr(step)`` on each agent's step; SGD calls
    ``lr(0)``, as the reference does."""
    rng = np.random.default_rng(0)
    theta = rng.normal(size=(3, 5)).astype(np.float32)
    grads = [rng.normal(size=(3, 5)).astype(np.float32) for _ in range(6)]
    sched = (1e-2, 2, 6, 0.2)
    ours = get_optimizer(name, cosine_schedule(*sched))
    ref = jopt.get_optimizer(name, jopt.cosine_schedule(*sched))
    got = _port_steps(ours, torch.tensor(theta), map(torch.tensor, grads))
    want = _jax_steps(ref, jnp.asarray(theta), map(jnp.asarray, grads))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # a constant callable is the float form, bit for bit
    flat = get_optimizer(name, 1e-2)
    const = get_optimizer(name, lambda step: 1e-2)
    a = _port_steps(flat, torch.tensor(theta), map(torch.tensor, grads))
    b = _port_steps(const, torch.tensor(theta), map(torch.tensor, grads))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("make", [adam, sgd])
def test_per_row_lr_equals_each_rows_scalar_run(make):
    """An (R,) learning rate over (R, K, d) parameters gives each row the
    bits of its own run at that rate."""
    rng = np.random.default_rng(1)
    lrs = [1e-2, 5e-3, 2e-2]
    theta = torch.tensor(rng.normal(size=(3, 4, 6)).astype(np.float32))
    grads = [torch.tensor(rng.normal(size=(3, 4, 6)).astype(np.float32))
             for _ in range(4)]
    rows = _port_steps(make(torch.tensor(lrs)), theta, grads)
    for r, lr in enumerate(lrs):
        one = _port_steps(make(lr), theta[r], [g[r] for g in grads])
        np.testing.assert_array_equal(rows[r], one)


def test_rate_forms():
    p = torch.zeros(2, 3, 4)
    assert topt._rate(0.5, None, p) == 0.5
    assert topt._rate(torch.tensor([1.0, 2.0]), None, p).shape == (2, 1, 1)
    r = topt._rate(lambda s: s.to(torch.float32) / 10,
                   torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32), p)
    assert r.shape == (2, 3, 1) and r.dtype == torch.float32
