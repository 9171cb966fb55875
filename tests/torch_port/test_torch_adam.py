"""The port's Adam / AdamW (``training/trainer.py`` ``Adam``, which
``make_optimizer`` builds for every ``eps_root``) against ``optax.adam`` /
``optax.adamw`` as the JAX package's ``make_optimizer`` builds them, on
the CPU: the same parameters and gradient sequence (numpy, from a seed)
through 6 steps, float32.

Limits, absolute on parameters of magnitude ~1-2: the port's Adam 5e-7
(4 float32 ulps at 1: optax's formula in the same order, rounded at
other places by XLA's fusion; measured at most 2.4e-7), for ``eps_root``
0 as for 1e-8.  (torch's Adam / AdamW, which the port built for
``eps_root == 0`` before, fold ``lr / (1 - b1^t)`` into one step size and
met optax only at 5e-6.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_learning_tpu.training.trainer import make_optimizer as ref_make_optimizer
from distributed_learning_tpu_torch.training.trainer import Adam, make_optimizer

STEPS, ATOL = 6, 5e-7


def _run_both(name, kw, lr=0.05, steps=STEPS, schedule=False):
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(3, 257)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) * (0.1 + i) for i in range(steps)]
    # Gradients near zero make eps_root's term matter.
    grads[2][:, :64] *= 1e-6
    rate = (lambda count: lr / (1.0 + count)) if schedule else lr
    tx = ref_make_optimizer(name, dict(kw), rate)
    state = tx.init(jnp.asarray(p0))
    p_ref = jnp.asarray(p0)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, p_ref)
        p_ref = optax.apply_updates(p_ref, upd)

    factory = make_optimizer(name, dict(kw), rate)
    p = torch.from_numpy(p0.copy())
    opt = factory(p)
    for i, g in enumerate(grads):
        if factory.schedule is not None:
            for group in opt.param_groups:
                group["lr"] = float(factory.schedule(i))
        p.grad = torch.from_numpy(g)
        opt.step()
    return np.asarray(jax.device_get(p_ref)), p.numpy(), opt


@pytest.mark.parametrize("eps_root", [0.0, 1e-8])
@pytest.mark.parametrize("name,kw", [
    ("adam", {}),
    ("adam", {"weight_decay": 1e-2, "b1": 0.8, "b2": 0.99, "eps": 1e-6}),
    ("adamw", {"weight_decay": 1e-2}),
])
def test_adam_matches_optax(name, kw, eps_root):
    ref, got, opt = _run_both(name, {**kw, "eps_root": eps_root})
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert type(opt) is Adam  # one Adam, whatever eps_root
    assert float(opt.state[opt.param_groups[0]["params"][0]]["step"]) == STEPS


def test_adam_eps_root_matters_and_takes_a_schedule():
    """The control: the port's Adam with eps_root 1e-8 differs from the
    same run at eps_root 0 by far more than the limit (the near-zero
    gradients' second moments sit under eps_root), and a learning-rate
    schedule read at the count before each update matches optax too."""
    with_root, _, _ = _run_both("adam", {"eps_root": 1e-8})
    without, _, _ = _run_both("adam", {"eps_root": 0.0})
    assert np.abs(with_root - without).max() > 100 * ATOL
    ref, got, _ = _run_both("adamw", {"eps_root": 1e-8, "weight_decay": 1e-2}, schedule=True)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_adam_state_lives_on_the_parameters_device_from_construction():
    p = torch.zeros(5, requires_grad=True)
    opt = Adam([p], lr=torch.tensor(0.1), eps_root=1e-8)
    st = opt.state[p]
    assert {k: (v.shape, v.device.type) for k, v in st.items()} == {
        "step": ((), "cpu"), "exp_avg": ((5,), "cpu"), "exp_avg_sq": ((5,), "cpu")}
    p.grad = torch.ones(5)
    opt.step()
    assert float(st["step"]) == 1.0
    # One step of Adam moves each coordinate by lr * 1 / (1 + ~eps): ~0.1.
    torch.testing.assert_close(p.detach(), torch.full((5,), -0.1), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name,kw", [("adam", {"weight_decay": 1e-2}), ("adamw", {"weight_decay": 1e-2})])
def test_adam_in_slices_equals_one_pass_bit_for_bit(name, kw, monkeypatch):
    """The update of a large buffer runs in slices of ``Adam.CHUNK``
    elements (its temporaries bounded by a slice); every element goes
    through the same operations, so 100-element slices of a (3, 257)
    buffer give the one-pass result bit for bit, with a float rate (the
    schedule) and with a 0-dim tensor rate (the card's)."""
    _, whole, _ = _run_both(name, {**kw, "eps_root": 1e-8}, schedule=True)
    monkeypatch.setattr(Adam, "CHUNK", 100)
    _, sliced, _ = _run_both(name, {**kw, "eps_root": 1e-8}, schedule=True)
    assert np.array_equal(sliced, whole)
    p, q = (torch.zeros(3, 257, requires_grad=True) for _ in range(2))
    opt_p = Adam([p], lr=torch.tensor(0.05), eps_root=1e-8, weight_decay=1e-2)
    opt_q = Adam([q], lr=torch.tensor(0.05), eps_root=1e-8, weight_decay=1e-2)
    opt_q.CHUNK = 1 << 26
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(3, 257)).astype(np.float32))
    for _ in range(3):
        p.grad, q.grad = g.clone(), g.clone()
        opt_p.step()
        opt_q.step()
    assert torch.equal(p, q)
