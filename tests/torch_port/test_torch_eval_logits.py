"""Eval-mode logits of the port's vision trainer against the JAX package's,
on the CPU: WRN-10-1 (dropout 0, augmentation off), 4 agents on a
Metropolis ring, SGD with momentum 0.9 and weight decay 5e-4, 3 epochs of
4 steps from the JAX trainer's init and batch statistics, on normalized
synthetic CIFAR-10 (24 test images), float32.

Eval mode normalises with the running statistics and runs no dropout.
Held, after the 3 epochs:

* each epoch's test accuracy (argmax hits) exactly;
* the eval path alone: the port's model with the JAX trainer's trained
  parameters and statistics loaded gives the JAX model's logits within
  1e-5 (measured 4.8e-7: float32 sums in another order);
* the whole run: the port's own trained logits within 3e-2 of the JAX
  trainer's (measured 9.8e-3 of logits up to 1.7).  The two trainers'
  parameters drift apart by ~1e-4 over these steps (ReLU inputs within
  float32 rounding of 0 take the other branch on one side,
  ``test_torch_trainer_vision.py``), and the eval amplifies that through
  10 layers normalised by running statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_tpu.data import normalize as jax_normalize
from distributed_learning_tpu.data import shard_dataset, synthetic_cifar
from distributed_learning_tpu.models.vision import WideResNet as JaxWRN
from distributed_learning_tpu.parallel import Topology as JaxTopology
from distributed_learning_tpu.training.trainer import GossipTrainer as JaxTrainer
from distributed_learning_tpu_torch.convert import flax_to_torch
from distributed_learning_tpu_torch.parallel import Topology
from distributed_learning_tpu_torch.training.trainer import GossipTrainer
from sharded_ranks import one_intra_op_thread

one_thread = pytest.fixture(scope="module", autouse=True)(one_intra_op_thread)

NODES = list(range(4))
B, STEPS, EPOCHS = 8, 4, 3
WRN = dict(depth=10, widen_factor=1, dropout_rate=0.0)


def test_wide_resnet_eval_logits_match_jax_after_3_epochs():
    (x, y), (xt, yt) = synthetic_cifar(n_train=4 * B * STEPS, n_test=24, seed=1)
    x = np.asarray(jax_normalize(jnp.asarray(x)))
    xt = np.asarray(jax_normalize(jnp.asarray(xt)))
    common = dict(node_names=NODES, optimizer="sgd",
                  optimizer_kwargs=dict(momentum=0.9, weight_decay=5e-4), learning_rate=0.05,
                  train_data=shard_dataset(x, y, NODES, batch_size=B, seed=0),
                  test_data=(xt, yt), epoch=EPOCHS, batch_size=B, epoch_len=STEPS, mix_times=1,
                  stat_step=1, eval_batch_size=16, seed=0)
    jt = JaxTrainer(model=JaxWRN(**WRN), weights=JaxTopology.ring(4), **common)
    jt.initialize_nodes()
    tt = GossipTrainer(model="wide-resnet", model_kwargs=WRN, weights=Topology.ring(4),
                       device="cpu", **common)
    convert = lambda tree: flax_to_torch(jax.tree.map(np.asarray, tree), n_agents=4)  # noqa: E731
    tt.initialize_nodes(params=convert(jt.state[0]), batch_stats=convert(jt.state[1]))
    for _ in range(EPOCHS):
        pj, pt = jt.train_epoch(), tt.train_epoch()
        np.testing.assert_array_equal(pt["test_acc"], np.asarray(pj["test_acc"]))

    model = JaxWRN(**WRN)
    want = np.asarray(jax.vmap(
        lambda p, b: model.apply({"params": p, "batch_stats": b}, jnp.asarray(xt), train=False)
    )(jt.state[0], jt.state[1]))
    xs = torch.as_tensor(xt).unsqueeze(0).expand(4, *xt.shape)
    tt.model.eval()
    with torch.no_grad():
        trained = tt.model(xs).numpy()
    assert trained.shape == want.shape == (4, 24, 10)
    np.testing.assert_allclose(trained, want, atol=3e-2, rtol=0)
    tt.model.load_stacked(convert(jt.state[0]))
    tt.model.load_stats(convert(jt.state[1]))
    with torch.no_grad():
        same_weights = tt.model(xs).numpy()
    np.testing.assert_allclose(same_weights, want, atol=1e-5, rtol=0)
    # The agents learned: eval accuracy rose above chance on both sides.
    assert np.asarray(pj["test_acc"]).mean() > 0.3 and pt["test_acc"].mean() > 0.3
