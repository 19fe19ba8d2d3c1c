"""The SwAV peer as a slice: ``python -m dedloc_tpu_torch.roles.swav
--training.mesh_devices 2`` on two gloo CPU ranks (torchrun's environment,
``DEDLOC_FORCE_CPU=1``), a solo peer for 2 boundaries with the queue
engaged from the start (a solo peer's progress view steps it at the second
boundary: the first boundary's samples reach its tracker after the first
check). Rank 0 leads and writes the checkpoint, whose names
and shapes are the one-device JAX peer's and which loads into a
one-device port peer."""
import jax
import jax.numpy as jnp
import numpy as np

from dedloc_tpu.data.multicrop import MultiCropSpec as JaxSpec
from dedloc_tpu.data.multicrop import synthetic_multicrop_batches as jax_batches
from dedloc_tpu.models import swav as jswav
from dedloc_tpu_torch.models.resnet import init_batch_stats
from dedloc_tpu_torch.models.swav import SwAVConfig, init_swav
from dedloc_tpu_torch.roles.swav import restore_checkpoint
from dedloc_tpu_torch.utils.checkpoint import load_latest_checkpoint
from torch_mesh_ranks import run_slice_cli


def _flags(out):
    return [
        "--dht.listen_host", "127.0.0.1",
        "--dht.experiment_prefix", "swav-slice",
        "--training.model_size", "tiny",
        "--training.mesh_devices", "2",
        "--training.per_device_batch_size", "4",
        "--training.max_local_steps", "2",
        "--training.queue_length", "8",
        "--training.queue_start_step", "0",
        "--training.warmup_steps", "2",
        "--training.total_steps", "50",
        "--training.save_steps", "1",
        "--training.output_dir", str(out),
        "--optimizer.target_batch_size", "8",
        "--averager.averaging_expiration", "0.5",
        "--averager.metadata_expiration", "300",
    ]


def test_swav_slice_peer_trains_and_checkpoints_as_one_device(tmp_path):
    out = tmp_path / "out"
    logs = run_slice_cli(str(tmp_path), 2, _flags(out), timeout=150,
                         module="dedloc_tpu_torch.roles.swav")
    lead, follow = logs
    assert "swav slice mesh: {'data': 2}, rank 0" in lead
    assert "rank 1" in follow and "DHT listening" not in follow
    assert "queue engaged at global step 0" in lead
    steps = [line for line in lead.splitlines() if "global step" in line and "loss" in line]
    assert 1 <= len(steps) <= 2, lead[-3000:]
    # the slice applies per leaf (the flat apply is off on a mesh)
    assert all("(apply leaf, group 1)" in line for line in steps)
    step, tree, _meta = load_latest_checkpoint(str(out))
    assert step == len(steps)
    # the one-device JAX peer's checkpoint schema: (params, batch_stats)
    jcfg = jswav.SwAVConfig.tiny()
    crops = [jnp.asarray(c) for c in next(jax_batches(JaxSpec.tiny(), 4, seed=0))]
    shapes = jax.eval_shape(
        lambda c: jswav.SwAVModel(jcfg).init(jax.random.PRNGKey(0), c, True), crops)
    want = {jax.tree_util.keystr(path): tuple(leaf.shape) for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                (shapes["params"], shapes["batch_stats"]))[0]}
    assert {k: tuple(np.shape(v)) for k, v in tree.items()} == want
    # and it loads into a one-device port peer
    model, params, stats = init_swav(SwAVConfig.tiny(queue_length=8), 7, "cpu")
    stats = restore_checkpoint(tree, params, init_batch_stats(model))
    assert all(np.isfinite(t.numpy()).all() for t in stats.values())
    assert all(np.isfinite(p.detach().numpy()).all() for p in params.values())
