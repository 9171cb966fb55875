"""The port's 4-agent gossip trainer on the rope + GQA + MoE LM with
``moe_aux_coef`` against the JAX package's ``GossipTrainer``, in float32
on the CPU, from the reference's init through ``convert.py`` (2 layers,
d 32 = 4 heads x 8, 2 KV heads, 4 experts, top-2 at capacity 1.0): over
2 epochs the per-step losses (the aux term included) and grad norms
(5e-5) and the parameters (2e-5, float32 sums in another order carried
through Adam); a trainer with ``moe_aux_coef=0`` differs."""

import jax
import numpy as np
import pytest

from distributed_learning_tpu.models.transformer import TransformerLM as JaxLM
from distributed_learning_tpu.parallel import Topology as JaxTopology
from distributed_learning_tpu.training.trainer import GossipTrainer as JaxTrainer
from distributed_learning_tpu_torch.convert import flax_to_torch
from distributed_learning_tpu_torch.models import TransformerLM
from distributed_learning_tpu_torch.parallel import Topology
from distributed_learning_tpu_torch.training.trainer import GossipTrainer
from sharded_ranks import one_intra_op_thread

one_thread = pytest.fixture(scope="module", autouse=True)(one_intra_op_thread)

V, T = 64, 16
BASE = dict(vocab_size=V, num_layers=2, num_heads=4, head_dim=8, max_len=T)
EXTRAS = dict(pos_emb="rope", num_kv_heads=2, mlp="moe", num_experts=4, moe_top_k=2,
              moe_capacity_factor=1.0)


NODES = list(range(4))


def _windows(n_seq, phases):
    phases = np.asarray(list(phases))
    starts = phases[np.arange(n_seq) % len(phases)]
    seq = (starts[:, None] + np.arange(T + 1)[None, :]) % V
    return seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)


def test_trainer_with_moe_aux_coef_matches_jax():
    """2 epochs of 2 steps, Adam, one gossip round an epoch on the ring,
    ``moe_aux_coef`` 0.05, dropout off (the reference's trainer cannot
    run a dropout model without its rng)."""
    kw = dict(EXTRAS)
    common = dict(
        node_names=NODES, optimizer="adam", learning_rate=3e-3, error="cross_entropy",
        train_data={a: _windows(12, range(16 * a, 16 * a + 16)) for a in NODES},
        test_data=None, epoch=2, batch_size=4, epoch_len=2, mix_times=1,
        stat_step=1, eval_batch_size=4, seed=0, moe_aux_coef=0.05, dropout=False)
    jt = JaxTrainer(model=JaxLM(**BASE, **kw), weights=JaxTopology.ring(4), **common)
    jt.initialize_nodes()
    p0 = flax_to_torch(jax.tree.map(np.asarray, jt.state[0]), n_agents=4)
    tt = GossipTrainer(model=TransformerLM(n_agents=4, device="cpu", **BASE, **kw),
                       weights=Topology.ring(4), device="cpu", **common)
    tt.initialize_nodes(params=p0)
    for _ in range(2):
        pj, pt = jt.train_epoch(), tt.train_epoch()
        for key in ("train_loss", "grad_norm"):
            np.testing.assert_allclose(pt[key], np.asarray(pj[key]), atol=5e-5)
        jp = flax_to_torch(jax.tree.map(np.asarray, jt.state[0]), n_agents=4)
        for name, p in tt.model.stacked_parameters().items():
            np.testing.assert_allclose(p.detach().numpy(), jp[name], atol=2e-5, err_msg=name)
    for a in NODES:
        np.testing.assert_allclose(tt.network[a].stats.train_loss,
                                   jt.network[a].stats.train_loss, atol=5e-5)
    # The trace is loss + coef * aux: a trainer without the aux term differs.
    tt0 = GossipTrainer(model=TransformerLM(n_agents=4, device="cpu", **BASE, **kw),
                        weights=Topology.ring(4), device="cpu", **dict(common, moe_aux_coef=0.0))
    tt0.initialize_nodes(params=p0)
    gap = tt0.train_epoch()["train_loss"] - jt.network[0].stats.train_loss[0]
    assert np.abs(gap).max() > 1e-3
