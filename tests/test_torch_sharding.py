"""The port's partition rules (``parallel/sharding.py``) against the JAX
package's: every port leaf's spec equals its JAX leaf's (TP rules on the
dense model, EP rules on the MoE one), the port layout of a spec, and
``models/convert.py``'s sharded <-> full conversion; and the tiny ALBERT
at tp=2 on a (1, 2) mesh of gloo ranks against the JAX trainer's slice on
the same mesh: loss and every leaf's gradient, and the params after 2
LAMB steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.models.albert import AlbertConfig as JaxConfig
from dedloc_tpu.models.albert import AlbertForPreTraining as JaxModel
from dedloc_tpu.parallel import sharding as jsh
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.models.albert import AlbertConfig, AlbertForPreTraining
from dedloc_tpu_torch.parallel import sharding as sh
from dedloc_tpu_torch.parallel.mesh import MeshLayout
from torch_mesh_jax import (
    assert_matches_jax,
    assert_replicas_bitwise,
    batches,
    jax_steps,
    port_inputs,
    weights,
)
from torch_mesh_ranks import run_ranks


def _jax_specs(cfg, rules):
    like = jax.eval_shape(lambda: JaxModel(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    flat = jax.tree_util.tree_flatten_with_path(jsh.partition_specs(like, rules),
                                                is_leaf=lambda x: isinstance(
                                                    x, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


@pytest.mark.parametrize("moe", [False, True])
def test_every_port_leaf_gets_its_jax_leafs_spec(moe):
    extra = dict(moe_experts=4) if moe else {}
    rules = sh.ALBERT_TP_RULES + sh.ALBERT_EP_RULES
    jax_rules = jsh.ALBERT_TP_RULES + jsh.ALBERT_EP_RULES
    model = AlbertForPreTraining(AlbertConfig.tiny(**extra))
    ours = sh.partition_specs(dict(model.named_parameters()), rules)
    want = _jax_specs(JaxConfig.tiny(**extra), jax_rules)
    got = {convert.grad_name(n, p.ndim)[0]: tuple(ours[n])
           for n, p in model.named_parameters()}
    assert got == want
    assert any(s for s in got.values())


def test_rules_are_the_jax_packages():
    assert [(p, tuple(s)) for p, s in sh.ALBERT_TP_RULES] == \
        [(p, tuple(s)) for p, s in jsh.ALBERT_TP_RULES]
    assert [(p, tuple(s)) for p, s in sh.ALBERT_EP_RULES] == \
        [(p, tuple(s)) for p, s in jsh.ALBERT_EP_RULES]


def test_port_spec_follows_the_layout():
    # a column-parallel kernel [in, out/tp] is the port's [out/tp, in]
    q = "albert.encoder.layer.block.attention.query.weight"
    assert sh.port_spec(q, 2, (None, "model")) == (("model", None))
    assert sh.port_spec("mlm_bias", 1, ("model",)) == ("model",)
    assert sh.port_spec("albert.word_embeddings.weight", 2, ("model", None)) == \
        ("model", None)


class _Rank(MeshLayout):
    """A layout seen from one rank, without a process group."""

    def __init__(self, axes, shape, rank):
        super().__init__(axes, shape)
        self.index = self.coords(rank)

    def axis_index(self, axis):
        return self.index.get(axis, 0)


def test_jax_params_convert_straight_to_a_ranks_blocks():
    named = weights()
    rules = sh.ALBERT_TP_RULES
    full = convert.params_from_jax(named)
    for rank in range(2):
        mesh = _Rank(("data", "model"), (1, 2), rank)
        blocks = convert.params_from_jax_sharded(named, mesh, rules)
        specs = sh.partition_specs(full, rules)
        for n, t in full.items():
            want = sh.shard_tensor(t, sh.port_spec(n, t.ndim, specs[n]), mesh)
            assert torch.equal(blocks[n], want), n
        q = "albert.encoder.layer.block.attention.query.weight"
        np.testing.assert_array_equal(blocks[q].numpy(),
                                      full[q].numpy()[16 * rank:16 * rank + 16])
    # the named form: a JAX kernel's block is cut along its own layout
    kname = "['albert']['encoder']['layer']['block']['attention']['dense']['kernel']"
    mesh = _Rank(("model",), (2,), 1)
    block = convert.shard_named({kname: named[kname]}, {kname: ("model", None)}, mesh)
    np.testing.assert_array_equal(block[kname], named[kname][16:])


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    w, b = weights(), batches()
    axes, shape = ("data", "model"), (1, 2)
    ref = jax_steps(axes, shape, w, b)
    outs = run_ranks(tmp_path_factory.mktemp("tp2"), 2, "albert_steps",
                     port_inputs(axes, shape, w, b))
    return ref, outs


def test_tiny_albert_tp2_matches_jax(tp2):
    ref, outs = tp2
    assert_matches_jax(outs[0], ref)
    assert_replicas_bitwise(outs, ("data", "model"), (1, 2))


def test_tp2_ranks_hold_half_the_heads_and_vocab(tp2):
    _ref, outs = tp2
    shapes = outs[1]["blocks_shapes"]
    assert shapes["albert.encoder.layer.block.attention.query.weight"] == (16, 32)
    assert shapes["albert.encoder.layer.block.attention.dense.weight"] == (32, 16)
    assert shapes["albert.word_embeddings.weight"] == (256, 16)
    assert shapes["mlm_bias"] == (256,)
    assert shapes["albert.encoder.layer.block.layernorm.weight"] == (32,)
