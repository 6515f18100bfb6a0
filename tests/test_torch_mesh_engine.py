"""The continuous-batching engine over a dp×tp mesh, held against the JAX
package on the CPU: one ``run_ranks`` launch of 4 gloo ranks (dp2·tp2;
rank bodies in ``tests/torch_mesh_ranks.py``, which imports no JAX) runs
every scenario, and the reference's offline greedy tokens are computed
here from the same weights (``params_from_jax``).

- the reference's five jobs (tests/test_generation.py:249-270) on the
  slot and paged layouts, the llama family (GQA with one KV head per tp
  rank, rope, swiglu) on both, prompts longer than a chunk through the
  chunked lane on both layouts and through the batched prefill: every
  greedy stream identical to the reference's offline greedy tokens;
- the prefix cache across dp ranks (tests/test_paged_attention.py:500-518,
  tests/test_prefix_cache.py:395-413): SHARED + [1] on the second dp
  rank's slot, then SHARED + [2] on the first's, ``prefix_hits == 1`` and
  both streams identical to the reference's;
- sampled streams under one seed per job identical to the port's
  unsharded engine's;
- rank 0 idle for twice the groups' timeout (heartbeats keep the
  followers); a driver stopped before it started;
- each rank's shard, the follower's refused submit, the reference's
  divisibility and KV-head errors, the driver's death (every follower of
  an unsupervised engine raises) and a silent follower (the driver's
  collective times out and the engine dies loudly);
- the dry run's steps 1-4 at 4 ranks (8 ranks: tests/test_torch_parallel.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from client_tpu.models import transformer as jt
from client_tpu_torch.parallel import collectives

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
            d_ff=64, max_seq=64, attn_impl="ref")
LLAMA = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=16,
             d_ff=64, max_seq=32, attn_impl="ref", n_kv_heads=2, rope=True,
             ffn="swiglu")
JOBS = [([3, 17, 42], 7), ([5, 11], 3), ([1], 9), ([9, 8, 7, 6, 5], 5),
        ([2, 4], 6)]
LONG_JOBS = [(list(range(2, 15)), 6), (list(range(20, 31)), 5),
             ([7] * 9, 4)]
SHARED = [int(x) for x in np.random.default_rng(0).integers(0, 64, 24)]
FILLER = [7, 7, 7]
LAUNCH_S = 240.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _offline_greedy(cfg, params, prompt, n):
    """The reference's offline greedy decode (one slot, token by token)."""
    step = jax.jit(functools.partial(jt.decode_step, cfg))
    with jax.default_matmul_precision("float32"):
        state = jt.init_decode_state(cfg)
        nxt = None
        for tok in prompt:
            logits, state = step(params, jnp.int32(tok), state)
            nxt = int(jnp.argmax(logits))
        out = []
        for _ in range(n):
            out.append(nxt)
            logits, state = step(params, jnp.int32(nxt), state)
            nxt = int(jnp.argmax(logits))
    return out


@pytest.fixture(scope="module")
def mesh_run():
    tcfg = jt.TransformerConfig(dtype=jnp.float32, **TINY)
    lcfg = jt.TransformerConfig(dtype=jnp.float32, **LLAMA)
    tparams = jt.init_params(jax.random.key(0), tcfg)
    lparams = jt.init_params(jax.random.key(0), lcfg)
    case = {"tiny": TINY, "tiny_params": _np(tparams), "llama": LLAMA,
            "llama_params": _np(lparams), "jobs": JOBS,
            "long_jobs": LONG_JOBS, "shared": SHARED, "filler": FILLER}
    got = collectives.run_ranks(ranks.mesh_engine, 4, "gloo", LAUNCH_S,
                                args=(case,))
    ref = {
        "tiny": [_offline_greedy(tcfg, tparams, p, b) for p, b in JOBS],
        "llama": [_offline_greedy(lcfg, lparams, p, b) for p, b in JOBS],
        "long": [_offline_greedy(tcfg, tparams, p, b) for p, b in LONG_JOBS],
        "shared": [_offline_greedy(tcfg, tparams, SHARED + [i], 5)
                   for i in (1, 2)],
    }
    return got, ref


@pytest.mark.parametrize("scenario,want", [
    ("slot", "tiny"), ("paged", "tiny"), ("llama_slot", "llama"),
    ("llama_paged", "llama"), ("chunked_slot", "long"),
    ("chunked_paged", "long"), ("batched_slot", "long")])
def test_greedy_streams_match_the_jax_offline_tokens(mesh_run, scenario,
                                                     want):
    got, ref = mesh_run
    assert got[0][scenario] == ref[want]
    assert all(r[scenario] is None for r in got[1:])


@pytest.mark.parametrize("scenario", ["paged_prefix", "slot_prefix"])
def test_a_prefix_hit_reads_blocks_another_dp_rank_wrote(mesh_run, scenario):
    got, ref = mesh_run
    r = got[0][scenario]
    # filler on slot 0 (dp rank 0), SHARED + [1] on slot 1 (dp rank 1),
    # SHARED + [2] on slot 0 again
    assert r["slots"] == [0, 1, 0]
    assert r["hits"] == 1
    assert r["tokens"] == ref["shared"]


def test_sampled_streams_equal_the_unsharded_engine(mesh_run):
    got, _ = mesh_run
    r = got[0]["sampled"]
    assert r["sharded"] == r["plain"]
    assert [len(t) for t in r["sharded"]] == [b for _, b in JOBS]


def test_each_rank_holds_its_shard(mesh_run):
    got, _ = mesh_run
    for r in got:
        # layers, d, 3, heads / tp, head_dim; vocab / tp rows
        assert r["shards"] == {"wqkv": (2, 32, 3, 1, 16), "embed": (32, 32)}
    state = got[0]["state"]
    assert state["pool_k"][2:] == (8, 1, 16)     # block_len, Hkv / tp, Dh
    assert state["pos"] == (2,)                  # n_slots / dp
    assert state["ring"][1] == 4                 # the ring holds all slots


def test_a_stopped_engine_destroys_its_groups(mesh_run):
    """Every rank's engine destroys its private process groups when rank
    0 stops it (the driver after its STOP plan, each follower after its
    loop returns)."""
    got, _ = mesh_run
    assert [r["groups_destroyed"] for r in got] == [True] * 4


def test_the_followers_outlast_an_idle_gap_on_heartbeats(mesh_run):
    """Rank 0's engine idles for twice the groups' timeout: its heartbeat
    plans keep the followers waiting, and the next stream is served."""
    got, ref = mesh_run
    assert got[0]["idle"] == ref["tiny"][:1]


def test_stopping_an_unstarted_driver_releases_its_followers(mesh_run):
    got, _ = mesh_run
    assert [r["unstarted"] for r in got] == [""] * 4


def test_a_follower_refuses_submit(mesh_run):
    got, _ = mesh_run
    assert got[0]["follower_submit"] == ""
    for r in got[1:]:
        assert r["follower_submit"].startswith("RuntimeError")
        assert "follower" in r["follower_submit"]


@pytest.mark.parametrize("case,exc,match", [
    ("n_slots", "ValueError", "n_slots 3 must be divisible by the mesh dp "
     "size 2"),
    ("kv_heads", "ValueError", "KV head count 2 must be divisible by the "
     "mesh tp size 4"),
    ("prefill_slots", "ValueError", "prefill_slots 3 must be divisible by "
     "the mesh dp size 2"),
    ("engine_devices", "ValueError", "which no rank of the live process "
     "group of 4 ranks holds")])
def test_the_reference_errors_raise_on_every_rank(mesh_run, case, exc,
                                                  match):
    got, _ = mesh_run
    for r in got:
        assert r["errors"][case].startswith(exc), r["errors"][case]
        assert match in r["errors"][case]


def test_the_drivers_death_raises_on_every_rank(mesh_run):
    got, _ = mesh_run
    death = got[0]["death"]
    assert death["healthy"] is False
    assert "503" in death["submit"] or "down" in death["submit"]
    for r in got[1:]:
        assert r["death"]["follower"].startswith("SpmdError"), r["death"]
        assert "InjectedFault" in r["death"]["follower"]


def test_a_silent_follower_times_the_driver_out(mesh_run):
    got, _ = mesh_run
    t = got[0]["timeout"]
    assert t["healthy"] is False
    assert t["failed"] != "NoneType: None"


def test_the_dry_run_steps_at_four_ranks(mesh_run):
    got, _ = mesh_run
    for r in got:
        assert set(r["dryrun"]) == {"dp_sp_tp", "dp_ep", "pp", "engine"}
        assert r["dryrun"]["engine"] == 5
        assert all(np.isfinite(v) for v in r["dryrun"].values())
    assert len({r["dryrun"]["dp_sp_tp"] for r in got}) == 1
