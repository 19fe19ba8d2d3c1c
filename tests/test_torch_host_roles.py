"""The port's host roles (aux, coordinator, DHT node, gateway) and the
serving plane beside the JAX package's: the aux template in the wire's
names, shapes and dtypes, the coordinator aggregating published metrics, the DHT node, the four roles
starting with no CUDA device and no ``DEDLOC_FORCE_CPU``, a gateway over
expert hosts serving what the port's ``moe_ffn`` computes, and the fleet
spawning the port's roles. An aux peer joining a round with a trainer is
``tests/test_torch_aux_peer.py``."""
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.roles import aux as jax_aux
from dedloc_tpu.roles.common import build_model as jax_build_model
from dedloc_tpu_torch.collaborative.metrics import LocalMetrics, publish_metrics
from dedloc_tpu_torch.core.config import CollaborationArguments, parse_config
from dedloc_tpu_torch.core.serialization import (
    CompressionType,
    deserialize_array,
    serialize_array,
)
from dedloc_tpu_torch.dht import DHT
from dedloc_tpu_torch.parallel import moe
from dedloc_tpu_torch.roles import aux, fleet
from dedloc_tpu_torch.roles.common import build_dht
from dedloc_tpu_torch.roles.coordinator import (
    CoordinatorCLIArguments,
    CoordinatorExtraArguments,
    run_coordinator,
)
from dedloc_tpu_torch.roles.dht_node import run_dht_node
from dedloc_tpu_torch.roles.gateway import GatewayService
from dedloc_tpu_torch.serving import ExpertHost, RouterPolicy, ffn_compute_fn

REPO = Path(__file__).resolve().parent.parent
BLOCK = "['albert']['encoder']['layer']['block']"


def _args(tmp_path, *extra):
    return parse_config(CollaborationArguments, [
        "--dht.listen_host", "127.0.0.1",
        "--training.model_size", "tiny",
        "--training.seq_length", "64",
        "--training.output_dir", str(tmp_path / "out"),
        "--averager.averaging_expiration", "1.0",
        "--averager.min_refresh_period", "0.1",
        "--averager.default_refresh_period", "0.3",
        *extra,
    ])


# ------------------------------------------------------------ aux template


def _jax_params_named(size, **overrides):
    cfg, model = jax_build_model(size, **overrides)
    params = jax.eval_shape(lambda r: model.init(
        r, jnp.zeros((1, 8), jnp.int32))["params"], jax.random.PRNGKey(0))
    return {jax.tree_util.keystr(path): (tuple(leaf.shape), np.dtype(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _layout(template):
    return {k: (v.shape, v.dtype) for k, v in template.items()}


@pytest.mark.parametrize("size,flags", [
    ("tiny", ()), ("tiny", ("--training.moe_experts", "4")), ("large", ())])
def test_aux_template_has_the_jax_models_names_shapes_and_dtypes(tmp_path, size,
                                                                 flags):
    """The template is the JAX model's gradient tree: names, shapes and
    dtypes (zeros, fp32), the MoE leaves with ``--training.moe_experts``."""
    args = _args(tmp_path, "--training.model_size", size, *flags)
    ours = aux._local_template(args)
    moe_experts = args.training.moe_experts
    assert _layout(ours) == _jax_params_named(size, moe_experts=moe_experts)
    assert all(v.dtype == np.float32 and not v.any() for v in ours.values())
    # the JAX aux's own fallback: the same names and dtypes for the dense
    # model; its shapes are 0-d (``_tree_to_named`` of ``eval_shape``'s
    # ShapeDtypeStructs) and it builds the dense model whatever the MoE
    # flag says (ROADMAP, faults in the reference)
    theirs = jax_aux._local_template(args)
    if moe_experts:
        assert set(ours) != set(theirs)
        assert f"{BLOCK}['moe_wi']" in ours and f"{BLOCK}['ffn']['kernel']" in theirs
    else:
        assert {k: v.dtype for k, v in ours.items()} == {
            k: v.dtype for k, v in theirs.items()}


# --------------------------------------------------- coordinator, DHT node


def test_dht_node_runs(tmp_path):
    run_dht_node(_args(tmp_path), keepalive_period=0.01, max_iterations=2)


def test_coordinator_aggregates_published_metrics(tmp_path):
    args = _args(tmp_path)
    log_path = str(tmp_path / "metrics.jsonl")
    peer_dht, public_key = build_dht(args)
    try:
        publish_metrics(
            peer_dht, args.dht.experiment_prefix, public_key,
            LocalMetrics(step=1, samples_per_second=12.5,
                         samples_accumulated=64, loss=6.0, mini_steps=3),
        )
        time.sleep(0.2)
        run_coordinator(
            _args(tmp_path, "--dht.initial_peers", peer_dht.get_visible_address()),
            CoordinatorExtraArguments(refresh_period=0.1,
                                      metrics_log_path=log_path),
            max_iterations=5,
        )
    finally:
        peer_dht.shutdown()
    lines = [json.loads(line) for line in Path(log_path).read_text().splitlines()]
    assert lines and lines[-1]["step"] == 1
    assert lines[-1]["alive_peers"] == 1
    assert abs(lines[-1]["loss"] - 2.0) < 1e-6  # 6.0 / 3 mini-steps


_START_ALL = r"""
import sys, torch
from dedloc_tpu_torch.core.config import CollaborationArguments, parse_config
from dedloc_tpu_torch.roles.aux import run_aux
from dedloc_tpu_torch.roles.coordinator import CoordinatorExtraArguments, run_coordinator
from dedloc_tpu_torch.roles.dht_node import run_dht_node
from dedloc_tpu_torch.roles.gateway import run_gateway

out = sys.argv[1]
args = parse_config(CollaborationArguments, [
    "--dht.listen_host", "127.0.0.1", "--training.model_size", "tiny",
    "--averager.averaging_expiration", "0.3"])
assert not torch.cuda.is_available()
run_dht_node(args, keepalive_period=0.01, max_iterations=1)
run_coordinator(args, CoordinatorExtraArguments(
    refresh_period=0.05, metrics_log_path=out + "/m.jsonl",
    incident_log_path=out + "/i.jsonl", ledger_log_path=out + "/l.jsonl"),
    max_iterations=1)
run_gateway(args, poll_period=0.01, max_iterations=1)
print("rounds", run_aux(args, poll_interval=0.01, max_iterations=1))
"""


def test_the_host_roles_start_without_a_card(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("DEDLOC_FORCE_CPU", "PYTHONPATH")}
    env.update(CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    run = subprocess.run([sys.executable, "-c", _START_ALL, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.strip() == "rounds 0"


# ---------------------------------------------------------------- serving


def _moe_setup(t=96):
    # capacity 18 of 24 tokens an expert on average: some go over
    cfg = moe.MoEConfig(hidden_size=32, ffn_size=64, num_experts=4,
                        capacity_factor=0.75)
    rng = np.random.default_rng(4)
    params = {"router": rng.normal(0, 0.5, (32, 4)).astype(np.float32),
              "wi": rng.normal(0, 32 ** -0.5, (4, 32, 64)).astype(np.float32),
              "wo": rng.normal(0, 64 ** -0.5, (4, 64, 32)).astype(np.float32)}
    x = rng.normal(0, 1, (t, 32)).astype(np.float32)
    return cfg, params, x


def test_gateway_over_expert_hosts_agrees_with_moe_ffn(tmp_path):
    """Two ``ExpertHost``s (experts 0-1 and 2-3, ``ffn_compute_fn``) and a
    ``GatewayService`` holding the router, each on its own DHT over
    loopback; a client's ``gateway.infer`` request equals the port's
    ``moe_ffn`` in fp32 on the tokens it keeps within capacity."""
    cfg, params, x = _moe_setup()
    root = DHT(start=True, listen_host="127.0.0.1")
    peers = [DHT(start=True, listen_host="127.0.0.1",
                 initial_peers=[root.get_visible_address()]) for _ in range(4)]
    hosts_dht, gateway_dht, client_dht = peers[:2], peers[2], peers[3]
    compute = ffn_compute_fn(params)

    async def host(node, experts):
        h = ExpertHost(node, "srv", experts, 1, compute_fn=compute)
        return await h.announce()

    async def gateway(node):
        service = GatewayService(node, "srv",
                                 policy=RouterPolicy(deadline_s=10.0,
                                                     attempt_timeout_s=5.0),
                                 router_params=params["router"], version=1)
        await service.router.refresh(force=True)
        return service.router.known_experts()

    try:
        for d, experts in zip(hosts_dht, ([0, 1], [2, 3])):
            assert d.run_coroutine(lambda node, e=experts: host(node, e))
        assert sorted(gateway_dht.run_coroutine(gateway)) == [0, 1, 2, 3]
        reply = client_dht.run_coroutine(lambda node: node.client.call(
            gateway_dht.endpoint, "gateway.infer",
            {"tokens": serialize_array(x, CompressionType.NONE),
             "request_id": "req-0"}, timeout=30.0))
    finally:
        for d in peers + [root]:
            d.shutdown()
    y = deserialize_array(reply["data"])
    assert reply["served"] == reply["tokens"] == x.shape[0]
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    xt = torch.from_numpy(x)
    ref, _aux = moe.moe_ffn(tp, xt, cfg)
    keep = moe.route(tp["router"], xt, cfg).keep.numpy()
    assert 0 < keep.sum() < x.shape[0]  # some tokens over capacity
    np.testing.assert_allclose(y[keep], ref.numpy()[keep], rtol=1e-5, atol=1e-5)
    # the gateway serves every token: the dropped ones too, where the layer
    # gives zeros
    assert np.abs(y[~keep]).max() > 0 and not ref.numpy()[~keep].any()


# ------------------------------------------------------------------ fleet


@pytest.mark.parametrize("force_cpu", [None, "1"])
def test_the_fleet_spawns_the_ports_roles_trainers_on_the_card(tmp_path, monkeypatch,
                                                               force_cpu):
    """The fleet spawns the port's roles: the coordinator and the aux peers
    with CUDA hidden, the trainers with the caller's environment, so they
    take the card unless the caller asks for the CPU."""
    spawned = []

    class _Proc:
        pid = 0

        def poll(self):
            return None

    def popen(argv, env=None, **_kw):
        spawned.append((argv, env))
        return _Proc()

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    if force_cpu is None:
        monkeypatch.delenv("DEDLOC_FORCE_CPU", raising=False)
    else:
        monkeypatch.setenv("DEDLOC_FORCE_CPU", force_cpu)
    monkeypatch.setattr(fleet.subprocess, "Popen", popen)
    local = fleet.LocalFleet(fleet.FleetArguments(output_dir=str(tmp_path)))
    local.start_coordinator()
    local.start_trainer(0)
    local.start_aux(0)
    modules = [argv[2] for argv, _env in spawned]
    assert modules == ["dedloc_tpu_torch.roles.coordinator",
                       "dedloc_tpu_torch.roles.trainer",
                       "dedloc_tpu_torch.roles.aux"]
    assert all(importlib.util.find_spec(m) is not None for m in modules)
    (_, coordinator), (_, trainer), (_, aux_env) = spawned
    assert coordinator["CUDA_VISIBLE_DEVICES"] == aux_env["CUDA_VISIBLE_DEVICES"] == ""
    assert "CUDA_VISIBLE_DEVICES" not in trainer
    assert trainer.get("DEDLOC_FORCE_CPU") == force_cpu
    # each role's own parser takes the flags the fleet gives it
    parse_config(CoordinatorCLIArguments, spawned[0][0][3:])
    for argv, _env in spawned[1:]:
        parse_config(CollaborationArguments, argv[3:])
