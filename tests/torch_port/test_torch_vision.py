"""The port's vision zoo, MLP and logreg against the JAX package's, on the
CPU in float32, from weights that ``convert.py`` carries across.

Two agents per model, each with its own flax init and its own batch, so
the checks also see that agent ``a``'s outputs depend on agent ``a``'s
weights and statistics only.  Per model: eval-mode logits, train-mode
logits, the gradient of the mean cross-entropy with respect to every
parameter, and the running statistics after the train-mode step.

Tolerances: logits within 2e-5 relative to the largest logit of the
batch (float32 convolutions summed in another order; ~1e-6 measured),
running statistics within 1e-5 relative (float32 means and variances;
the port recovers the variance from the kernel's 1/sqrt(var + eps)).

Gradients are compared in float64 on both sides (the JAX model built
with ``dtype=float64`` under ``jax.enable_x64``, the port's model as a
float64 copy running the same modules), within 1e-9 relative to each
leaf's largest entry (plus 1e-12 absolute, for leaves whose gradient is
exactly zero).  In float32 they cannot be held tightly: a ReLU
whose input lies within float32 rounding of 0 takes one branch in one
implementation and the other in the other (measured: one element of
ResNet-20's first block, ``y + residual`` = 1.5e-8 in one and -7e-8 in
float64), and that one element moves the leaf gradients upstream of it
by up to 0.5% in norm.  In float64 the band is 1e-16 wide.
``convert.py``'s round trip is bit-exact.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_tpu.models import logreg as jax_logreg
from distributed_learning_tpu.models.mlp import ANNModel as JaxANN
from distributed_learning_tpu.models.vision import (
    VGG as JaxVGG,
    LeNet as JaxLeNet,
    ResNet as JaxResNet,
    WideResNet as JaxWRN,
)
from distributed_learning_tpu_torch.convert import flax_to_torch, torch_to_flax
from distributed_learning_tpu_torch.models import get_model, logreg
from distributed_learning_tpu_torch.models.mlp import ANNModel
from distributed_learning_tpu_torch.models.vision import (
    VGG,
    Dropout,
    LeNet,
    ResNet,
    WideResNet,
)
from sharded_ranks import one_intra_op_thread

one_thread = pytest.fixture(scope="module", autouse=True)(one_intra_op_thread)

N, B = 2, 4
LOGIT_RTOL, GRAD_RTOL, STAT_RTOL = 2e-5, 1e-9, 1e-5
# A conv bias that feeds a train-mode BatchNorm has a gradient of exactly
# zero (the BatchNorm removes the mean); in float64 both sides give ~1e-17.
GRAD_ATOL = 1e-12

# name -> (JAX model for a dtype, port model)
CASES = {
    "lenet": (lambda dt: JaxLeNet(num_classes=10, dtype=dt),
              lambda: LeNet(num_classes=10, n_agents=N, device="cpu")),
    "vgg11": (lambda dt: JaxVGG(depth=11, num_classes=10, dtype=dt),
              lambda: VGG(depth=11, num_classes=10, n_agents=N, device="cpu")),
    "resnet20": (lambda dt: JaxResNet(depth=20, num_classes=10, dtype=dt),
                 lambda: ResNet(depth=20, num_classes=10, n_agents=N, device="cpu")),
    "resnet18": (lambda dt: JaxResNet(depth=18, num_classes=10, dtype=dt),
                 lambda: ResNet(depth=18, num_classes=10, n_agents=N, device="cpu")),
    "wrn10-1": (lambda dt: JaxWRN(depth=10, widen_factor=1, dropout_rate=0.0, dtype=dt),
                lambda: WideResNet(depth=10, widen_factor=1, dropout_rate=0.0,
                                   n_agents=N, device="cpu")),
    "wrn16-2": (lambda dt: JaxWRN(depth=16, widen_factor=2, dropout_rate=0.0, dtype=dt),
                lambda: WideResNet(depth=16, widen_factor=2, dropout_rate=0.0,
                                   n_agents=N, device="cpu")),
    "ann": (lambda dt: JaxANN(hidden_dim=32, output_dim=10, dtype=dt),
            lambda: ANNModel(hidden_dim=32, output_dim=10, input_shape=(32, 32, 3),
                             n_agents=N, device="cpu")),
}


def _stack(trees):
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *trees)


def _images(seed):
    return np.random.default_rng(seed).normal(size=(N, B, 32, 32, 3)).astype(np.float32)


def _labels(seed):
    return np.random.default_rng(seed).integers(0, 10, size=(N, B)).astype(np.int32)


def _rel(got, want, rtol, what, atol=0.0):
    """max |got - want| <= rtol * max |want| + atol."""
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert err <= rtol * scale + atol, f"{what}: error {err:.3g} against max |want| {scale:.3g}"


def _jax_side(jm, variables, x, y, grads=False):
    """Per agent: eval logits, train logits and new batch stats, or (with
    ``grads``) the gradients, in the dtype of ``jm`` and ``variables``
    (one jitted program, shared by the agents)."""
    has_bs = "batch_stats" in variables

    def loss(p, v, xa, ya):
        out, mut = jm.apply(dict(v, params=p), xa, train=True,
                            mutable=["batch_stats"] if has_bs else [])
        logp = jax.nn.log_softmax(out.astype(xa.dtype))
        return -jnp.mean(jnp.take_along_axis(logp, ya[:, None], 1)), (out, mut)

    def forward(p, v, xa, ya):
        return jm.apply(v, xa, train=False), loss(p, v, xa, ya)[1]

    fn = jax.jit(jax.grad(loss, has_aux=True) if grads else forward)
    evals, trains, grad_trees, stats = [], [], [], []
    for a in range(N):
        v = jax.tree.map(lambda t: jnp.asarray(t[a]), variables)
        res = fn(v["params"], v, jnp.asarray(x[a]), jnp.asarray(y[a]))
        if grads:
            grad_trees.append(jax.tree.map(np.asarray, res[0]))
            continue
        ev, (out, mut) = res
        evals.append(np.asarray(ev))
        trains.append(np.asarray(out))
        stats.append(jax.tree.map(np.asarray, mut.get("batch_stats", {})))
    if grads:
        return _stack(grad_trees)
    return np.stack(evals), np.stack(trains), _stack(stats) if stats[0] else {}


def _port_loss(model, x, y):
    out = model(torch.tensor(x))
    return out, torch.nn.functional.cross_entropy(
        out.to(model.dtype).reshape(-1, 10), torch.tensor(y).long().reshape(-1),
        reduction="none").reshape(N, B).mean(1).sum()


@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_jax(case):
    make_jax, make_port = CASES[case]
    jm = make_jax(jnp.float32)
    x, y = _images(1), _labels(2)
    init = jax.jit(lambda key, xa: jm.init(key, xa, train=False))
    variables = _stack([jax.tree.map(np.asarray, init(jax.random.key(a), jnp.asarray(x[a])))
                        for a in range(N)])
    want_eval, want_train, want_stats = _jax_side(jm, variables, x, y)

    model = make_port()
    model.load_stacked(flax_to_torch(variables["params"], n_agents=N))
    if "batch_stats" in variables:
        model.load_stats(flax_to_torch(variables["batch_stats"], n_agents=N))
    xt = torch.tensor(x)
    model.eval()
    with torch.no_grad():
        _rel(model(xt).numpy(), want_eval, LOGIT_RTOL, "eval logits")
    model64 = copy.deepcopy(model).double()  # same modules, float64 copies
    model64.dtype = torch.float64
    model.train()
    model.flat_grads.zero_()
    out, loss = _port_loss(model, x, y)
    loss.backward()
    _rel(out.detach().numpy(), want_train, LOGIT_RTOL, "train logits")
    assert torch.count_nonzero(model.flat_grads) > 0  # grads land in the flat buffer
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda t: np.asarray(t, np.float64), variables)
        want_grads = _jax_side(make_jax(jnp.float64), v64, x.astype(np.float64), y, grads=True)
    model64.train()
    _, loss64 = _port_loss(model64, x.astype(np.float64), y)
    got = dict(zip(model.stacked_parameters(), torch.autograd.grad(loss64, list(model64.parameters()))))
    want = flax_to_torch(want_grads, n_agents=N)
    assert set(got) == set(want)
    for name, g in got.items():
        _rel(g.numpy(), want[name], GRAD_RTOL, f"grad {name}", atol=GRAD_ATOL)
    if want_stats:
        got = {k: v.numpy() for k, v in model.stacked_stats().items()}
        want = flax_to_torch(want_stats, n_agents=N)
        assert set(got) == set(want) and got
        for name, s in got.items():
            _rel(s, want[name], STAT_RTOL, f"batch stat {name}")
    else:
        assert model.stacked_stats() == {}


def test_wide_resnet_names_cover_both_block_kinds():
    """WRN-16-2's first block of each stage projects (Conv_0 is its 1x1
    shortcut, then Conv_1, Conv_2); the others do not (Conv_0, Conv_1).
    The port's names are exactly the flax tree's, stats included."""
    jm = JaxWRN(depth=16, widen_factor=2, dropout_rate=0.0)
    v = jax.tree.map(lambda t: np.zeros(t.shape, t.dtype), jax.eval_shape(
        lambda: jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False)))
    model = WideResNet(depth=16, widen_factor=2, dropout_rate=0.0, device="cpu")
    want = flax_to_torch(v["params"])
    assert set(model.stacked_parameters()) == set(want)
    assert {k for k in want if k.startswith("_WideBasic_0.Conv")} == {
        "_WideBasic_0.Conv_0.kernel", "_WideBasic_0.Conv_0.bias",
        "_WideBasic_0.Conv_1.kernel", "_WideBasic_0.Conv_1.bias",
        "_WideBasic_0.Conv_2.kernel", "_WideBasic_0.Conv_2.bias"}
    assert want["_WideBasic_0.Conv_0.kernel"].shape == (32, 16, 1, 1)
    assert "_WideBasic_1.Conv_2.kernel" not in want
    assert want["_WideBasic_1.Conv_0.kernel"].shape == (32, 32, 3, 3)
    stats = flax_to_torch(v["batch_stats"])
    assert set(model.stacked_stats()) == set(stats)


def test_wide_resnet_28_10_param_count():
    """The flagship at full size, one agent: 36,489,290 parameters, as
    the JAX package counts them (from its shapes alone)."""
    n = sum(np.prod(t.shape) for t in jax.tree.leaves(jax.eval_shape(
        lambda: JaxWRN(depth=28, widen_factor=10).init(
            jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False)["params"])))
    assert n == 36_489_290
    model = get_model("wide-resnet", 10, n_agents=1, device="cpu")
    assert model.param_count() == n


@functools.lru_cache(maxsize=None)
def _zeros_init(case):
    """The jitted flax init of ``case`` on a zero image (one compile for
    both parametrizations of a case)."""
    jm = CASES[case][0](jnp.float32)
    return jax.jit(lambda key: jm.init(key, jnp.zeros((1, 32, 32, 3)), train=False))


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("case", ["lenet", "resnet20", "wrn10-1", "ann"])
def test_convert_round_trip_is_bit_exact(case, stacked):
    trees = [jax.tree.map(np.asarray, _zeros_init(case)(jax.random.key(a))) for a in range(N)]
    variables = _stack(trees) if stacked else trees[0]
    n = N if stacked else None
    for col in variables:
        port = flax_to_torch(variables[col], n_agents=n)
        back = torch_to_flax(port, n_agents=n)
        flat_a = jax.tree_util.tree_flatten_with_path(variables[col])[0]
        flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(flat_b[path], leaf)


def test_lenet_flatten_order_is_flax_nhwc():
    """A Dense_0 kernel whose rows are permuted into NCHW order gives
    other logits: the port flattens in flax's (H, W, C) order."""
    jm = JaxLeNet()
    x = _images(3)[:1]
    v = jax.tree.map(np.asarray, _zeros_init("lenet")(jax.random.key(0)))
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x[0])))
    model = LeNet(n_agents=1, device="cpu")
    model.load_stacked(flax_to_torch(v["params"]))
    model.eval()
    with torch.no_grad():
        _rel(model(torch.tensor(x))[0].numpy(), want, LOGIT_RTOL, "lenet logits")
        k = model.Dense_0.kernel
        perm = np.arange(1024).reshape(8, 8, 16).transpose(2, 0, 1).reshape(-1)
        k.copy_(k[:, perm])
        assert not np.allclose(model(torch.tensor(x))[0].numpy(), want, atol=1e-3)


def test_logreg_matches_jax():
    """``loss_fn``, ``grad_step`` and ``accuracy``, for one weight vector
    and for agent-stacked ones (what vmap does in the JAX package);
    float32, 1e-6 relative."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3, 40, 7)).astype(np.float32)
    y = np.where(rng.random((3, 40)) < 0.5, -1.0, 1.0).astype(np.float32)
    w = rng.normal(size=(3, 7)).astype(np.float32)
    tau, lr = 1e-2, 0.3
    tw, tX, ty = map(torch.tensor, (w, X, y))
    for a in range(3):
        jl = float(jax_logreg.loss_fn(w[a], X[a], y[a], tau))
        assert float(logreg.loss_fn(tw[a], tX[a], ty[a], tau)) == pytest.approx(jl, rel=1e-6)
        jw, jloss = jax_logreg.grad_step(w[a], X[a], y[a], lr=lr, tau=tau)
        pw, ploss = logreg.grad_step(tw[a], tX[a], ty[a], lr=lr, tau=tau)
        np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
        assert float(ploss) == pytest.approx(float(jloss), rel=1e-6)
        assert float(logreg.accuracy(tw[a], tX[a], ty[a])) == float(
            jax_logreg.accuracy(w[a], X[a], y[a]))
    stacked_w, _ = logreg.grad_step(tw, tX, ty, lr=lr, tau=tau)
    for a in range(3):
        np.testing.assert_allclose(stacked_w[a].numpy(), np.asarray(
            jax_logreg.grad_step(w[a], X[a], y[a], lr=lr, tau=tau)[0]), rtol=1e-6, atol=1e-7)
    model = logreg.LogisticRegression(dim=7, lr=lr, tau=tau, device="cpu")
    ref = jax_logreg.LogisticRegression(dim=7, lr=lr, tau=tau)
    for _ in range(3):
        assert model.fit(X[0], y[0]) == pytest.approx(ref.fit(X[0], y[0]), rel=1e-6)
    assert model.calc_accuracy(X[1], y[1]) == ref.calc_accuracy(X[1], y[1])


def test_dropout_keeps_seventy_percent_scaled_and_repeats_under_a_seed():
    gens = [torch.Generator().manual_seed(5), torch.Generator().manual_seed(6)]
    drop = Dropout(0.3, gens)
    xs = [torch.ones(64, 16, 8, 8), torch.ones(64, 16, 8, 8)]
    out = drop(xs)
    for o in out:
        kept = (o != 0).float().mean().item()
        assert abs(kept - 0.7) < 0.01, kept
        assert torch.allclose(o[o != 0], torch.full_like(o[o != 0], 1 / 0.7))
    assert not torch.equal(out[0], out[1])  # each agent its own stream
    gens[0].manual_seed(5)
    gens[1].manual_seed(6)
    again = drop(xs)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    drop.eval()
    assert drop(xs) is xs


def test_get_model_resolves_every_name_and_positional_size():
    for name in ("lenet", "vggnet", "resnet", "wide-resnet", "wide_resnet",
                 "ann", "mlp", "transformer"):
        kw = {"depth": 10, "widen_factor": 1} if "wide" in name else {}
        kw.update({"depth": 11} if name == "vggnet" else {})
        kw.update({"depth": 20} if name == "resnet" else {})
        m = get_model(name, 7, n_agents=1, device="cpu", **kw)
        assert m.n_agents == 1
    assert get_model("ann", 7, device="cpu", input_shape=(5,)).Dense_3.kernel.shape == (1, 150, 7)
    assert get_model("ann", 7, device="cpu", input_shape=(5,)).Dense_0.kernel.shape == (1, 5, 150)
    assert get_model("lenet", 3, device="cpu").Dense_2.kernel.shape == (1, 84, 3)
    with pytest.raises(ValueError, match="unknown model"):
        get_model("moe", device="cpu")
    with pytest.raises(ValueError, match="both positionally"):
        get_model("lenet", 3, num_classes=4, device="cpu")
