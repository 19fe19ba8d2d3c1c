"""Checkpoints across packages: the JAX package's ``run_swav`` resumes from
the port's SwAV checkpoint, and the port's from the JAX peer's (the tiny
config on the CPU; ``(params, batch_stats)`` under the JAX names)."""
import flax.linen
import jax
import numpy as np

from dedloc_tpu.collaborative.optimizer import _tree_to_named
from dedloc_tpu.core import trainer as jax_trainer
from dedloc_tpu.core.config import SwAVCollaborationArguments as JaxArgs
from dedloc_tpu.core.config import parse_config as jax_parse
from dedloc_tpu.core.hooks import LoopContext as JaxLoopContext
from dedloc_tpu.roles import swav as jax_role
from dedloc_tpu_torch.core.config import SwAVCollaborationArguments, parse_config
from dedloc_tpu_torch.roles.swav import run_swav
from dedloc_tpu_torch.utils.checkpoint import load_latest_checkpoint
from test_torch_swav_role import _argv, logs, one_torch_thread  # noqa: E402,F401 (fixtures)


def test_checkpoints_restore_across_packages(tmp_path, logs, monkeypatch,
                                             one_torch_thread):
    """Port -> JAX: the JAX ``run_swav`` resumes from the port's checkpoint
    (its training loop replaced by one phase end, which saves through the
    JAX role's own ``save_fn``). JAX -> port: the port's ``run_swav``
    resumes from that JAX-written checkpoint and steps on."""
    out = str(tmp_path / "out")
    run_swav(parse_config(SwAVCollaborationArguments, _argv(out)))
    step, ported, _meta = load_latest_checkpoint(out)
    assert step >= 1

    def one_phase_end(self, state, batches, max_steps, steps_per_phase=None, ctx=None):
        ctx = JaxLoopContext()
        ctx.train_state = state
        self.hooks.dispatch("on_phase_end", ctx)
        return state, ctx

    monkeypatch.setattr(jax_trainer.Trainer, "train", one_phase_end)
    # the JAX role initialises its model op by op (~30 s on this CPU); the
    # same init under jit gives the same weights, which the restore then
    # overwrites anyway
    eager_init = flax.linen.Module.init
    monkeypatch.setattr(jax_role.SwAVModel, "init", lambda self, rng, crops, train: jax.jit(
        lambda r, c: eager_init(self, r, c, train))(rng, crops))
    logs.clear()
    jstate = jax_role.run_swav(jax_parse(JaxArgs, _argv(out)))
    assert any(f"resumed from local checkpoint at step {step}" in m for m in logs), logs
    restored = _tree_to_named(jax.device_get(jstate.params))
    for name, arr in restored.items():
        assert arr.tobytes() == np.asarray(ported["[0]" + name]).tobytes(), name
    # the JAX role re-saved the step it resumed: the same tree, bitwise
    step2, rewritten, _ = load_latest_checkpoint(out)
    assert step2 == step and sorted(rewritten) == sorted(ported)
    for name, arr in ported.items():
        assert np.asarray(rewritten[name]).tobytes() == np.asarray(arr).tobytes(), name
    monkeypatch.undo()
    monkeypatch.setenv("DEDLOC_FORCE_CPU", "1")
    logs.clear()
    state = run_swav(parse_config(SwAVCollaborationArguments, _argv(out)))
    assert any(f"resumed from local checkpoint at step {step}" in m for m in logs), logs
    assert int(state.step) > step
