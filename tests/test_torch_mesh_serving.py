"""A mesh-sharded model behind the port's serving stack, the counterpart
of tests/test_distributed_serving.py: one ``run_ranks`` launch of 8 gloo
ranks (dp2·tp4; rank bodies in ``tests/torch_mesh_ranks.py``) builds a
``TorchModel(mesh=, param_sharding=, input_sharding=)`` on every rank;
rank 0 serves it over HTTP and the other ranks follow its forwards.

- logits over HTTP against the JAX package's unsharded ``forward`` at
  rtol = atol = 2e-3 (the reference's tolerance) and against the port's
  unsharded forward at 1e-5;
- the same through a CUDA shared-memory region (``device="cpu"``);
- every rank holds V/4 rows of ``embed``;
- after an idle gap of twice the groups' timeout (rank 0's heartbeat
  plans keep the followers), the same request is answered alike;
- the config JSON carries the ``sharding`` block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from client_tpu.models import transformer as jt
from client_tpu_torch.parallel import collectives

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8,
           d_ff=64, max_seq=32, causal=False)
SEQ = 16
LAUNCH_S = 240.0


@pytest.fixture(scope="module")
def served():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **CFG)
    params = jt.init_params(jax.random.key(0), jcfg)
    tokens = np.arange(2 * SEQ, dtype=np.int32).reshape(2, SEQ) % 64
    case = {"cfg": CFG, "params": jax.tree.map(np.asarray, params),
            "seq": SEQ, "tokens": tokens}
    got = collectives.run_ranks(ranks.mesh_serving, 8, "gloo", LAUNCH_S,
                                args=(case,))
    with jax.default_matmul_precision("float32"):
        want = {"http": np.asarray(jt.forward(jcfg, params,
                                              jnp.asarray(tokens))[0]),
                "shm": np.asarray(jt.forward(
                    jcfg, params, jnp.ones((2, SEQ), jnp.int32))[0])}
    return got, want


@pytest.mark.parametrize("route", ["http", "shm"])
def test_sharded_infer_matches_the_jax_forward(served, route):
    got, want = served
    np.testing.assert_allclose(got[0][route], want[route], rtol=2e-3,
                               atol=2e-3)


def test_sharded_infer_matches_the_ports_unsharded_forward(served):
    got, _ = served
    np.testing.assert_allclose(got[0]["http"], got[0]["plain"], rtol=1e-5,
                               atol=1e-5)


def test_the_followers_outlast_an_idle_gap_on_heartbeats(served):
    """Rank 0 idles for twice the groups' timeout; its heartbeat plans
    keep the followers waiting, and the next request is served alike."""
    got, _ = served
    np.testing.assert_array_equal(got[0]["after_idle"], got[0]["http"])


def test_every_rank_holds_a_quarter_of_the_vocab(served):
    got, _ = served
    assert [r["embed_rows"] for r in got] == [64 // 4] * 8


def test_an_unloaded_model_destroys_its_groups(served):
    """The core's stop unloads the model on rank 0, which ends the
    followers; every rank then holds none of the model's groups."""
    got, _ = served
    assert [r["groups_destroyed"] for r in got] == [True] * 8


def test_the_config_carries_the_sharding_block(served):
    got, _ = served
    block = {"mesh_axes": ["dp", "tp"], "mesh_shape": [2, 4],
             "batch_axis": "dp"}
    assert got[0]["config"]["sharding"] == block


def test_the_grpc_config_carries_the_sharding_block(served):
    """The gRPC ``ModelConfig``'s sharding block, as the reference's
    client_tpu/server/grpc_server.py:284-287 fills it (the client's JSON
    keeps the proto's field names; int64 shapes read as strings)."""
    got, _ = served
    if "grpc_config" not in got[0]:
        pytest.skip("grpcio is not installed")
    assert got[0]["grpc_config"]["sharding"] == {
        "mesh_axes": ["dp", "tp"], "mesh_shape": ["2", "4"],
        "batch_axis": "dp"}
