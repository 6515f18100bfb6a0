"""Replica fleets whose replicas shard over the ranks, held against the
JAX package's fleets on the CPU: one ``run_ranks`` launch of 4 gloo ranks
(rank body ``mesh_fleet`` in ``tests/torch_mesh_ranks.py``, which imports
no JAX) runs every scenario, rank 0 routing and driving every replica
through the fleet's one plan channel, and the reference's fleets are
built here over the forced host devices with the same f32 weights
(``params_from_jax``):

- (a) ``fleet=2`` under a dp2×tp2 mesh, every replica over the whole
  mesh: tenant jobs routed to the same replicas with the same decisions,
  counters and greedy tokens as the JAX fleet under the same mesh;
- (b) ``replica_devices=[(0, 1), (2, 3)]``: each replica on a 2×1 dp mesh
  of its rank pair, rank 0 driving replica 1 without a shard of it (the
  ring, the memory ledger and the tier's block size come back from rank
  2); each rank's shard shapes;
- (c) a replica attached past the declared subsets takes the default
  placement (an unsharded engine on rank 0), and the jobs route over
  three replicas as the JAX fleet's do;
- the slot layout with the prefix cache and the host tier over the rank
  pairs (2, 3) and (0, 1): rank 0 drives replica 0 without a shard,
  its store sized in the reporter's whole-block bytes, blocks spilled
  and restored by plans, the memory ledger read from rank 2, and the
  greedy tokens the JAX fleet's;
- (d) under the mesh with supervision: a stream drained mid-flight, a
  rolling restart, an attach and an injected crash of replica 1, with no
  failed stream, every follower rebuilding replica 1 with rank 0, and
  the jobs again the reference's tokens;
- (e) the (replica, op) plans every rank's channel carried, identical on
  all four ranks in every scenario;
- (f) an autoscaled fleet under the mesh: the controller's steps attach
  a replica under a held queue and drain and detach it once idle,
  decision for decision as the JAX controller decides.

Tokens, routing decisions and counters exact (f32 weights).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from client_tpu.models import decoder_lm as jlm
from client_tpu.models import transformer as jt
from client_tpu.parallel.mesh import make_mesh as jax_mesh
from client_tpu_torch.parallel import collectives

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
            d_ff=64, max_seq=64, attn_impl="ref")
KNOBS = dict(n_slots=2, chunk_size=4, max_new_tokens=6, kv_layout="paged",
             kv_block_len=8, prefill_mode="chunked", prefill_chunk=16)
A = [int(x) for x in (np.arange(20) * 7 + 3) % 60 + 1]
B = [int(x) for x in (np.arange(20) * 5 + 11) % 60 + 1]
# tenants whose hashes send cold prompts to both replicas; A's and B's
# 16-token blocks bring the affinity leg in
JOBS = [(A[:16] + [1, 2], 5, "acme"), (B[:16] + [3], 5, "beta"),
        (A[:16] + [4, 5, 6], 5, "gamma"), ([7, 8, 9], 4, "globex"),
        (B[:16] + [9, 9], 5, "acme"), (A + [2], 5, "initech")]
# four 17-token families of one tenant: two blocks each, eight in all,
# through a prefix pool of four
FAMILIES = [[int(x) for x in (np.arange(17) * (3 + k) + 5 * k) % 60 + 1]
            for k in range(4)]
AUTOSCALE = dict(min_replicas=1, max_replicas=2, queue_high=3, queue_low=0,
                 burn_high=1.0, burn_low=0.2, hold_rounds=2, idle_rounds=2,
                 cooldown_s=0.0, interval_s=0.0)
LAUNCH_S = 240.0
SCENARIOS = ["mesh", "subsets", "tier", "lifecycle", "autoscale"]


def _reference(jcfg, jparams) -> dict:
    """The JAX package's fleets over the forced host devices: (a) under a
    dp2×tp2 mesh, (b, c) over device pairs with a replica attached past
    them, the mid-drain stream's tokens, and (f) the autoscaled fleet."""
    mesh = jax_mesh({"dp": 2, "tp": 2}, devices=jax.devices()[:4],
                    axes=("dp", "tp"))
    out = {}
    m = jlm.make_continuous_generator("fm_lm", cfg=jcfg, params=jparams,
                                      mesh=mesh, fleet=2, **KNOBS)
    try:
        out["mesh"] = ranks._routed(m.fleet, JOBS)
        prompt = np.asarray(JOBS[0][0], np.int32)
        out["long"] = list(m.fleet.submit(prompt, 20, tenant_id="acme"))
        out["families"] = [list(m.fleet.submit(np.asarray(f, np.int32), 5,
                                               tenant_id="acme"))
                           for f in FAMILIES + FAMILIES[:1]]
    finally:
        m.shutdown()
    m = jlm.make_replica_fleet("fs_lm", replicas=2, cfg=jcfg,
                               params=jparams,
                               replica_devices=[(0, 1), (2, 3)], **KNOBS)
    try:
        first = ranks._routed(m.fleet, JOBS)
        idx = m.fleet.attach_replica()
        out["subsets"] = {"first": first, "idx": idx,
                          "second": ranks._routed(m.fleet, JOBS)}
    finally:
        m.shutdown()
    m = jlm.make_replica_fleet("fa_lm", replicas=1, cfg=jcfg,
                               params=jparams, mesh=mesh,
                               autoscale=AUTOSCALE, **KNOBS)
    try:
        out["autoscale"] = ranks._autoscaled(m, {"fleet_jobs": JOBS})
    finally:
        m.shutdown()
    return out


@pytest.fixture(scope="module")
def fleet_run():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **TINY)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    case = {"tiny": TINY,
            "tiny_params": jax.tree.map(np.asarray, jparams),
            "fleet_jobs": JOBS, "fleet_knobs": KNOBS,
            "tier_families": FAMILIES,
            "autoscale": AUTOSCALE}
    got = collectives.run_ranks(ranks.mesh_fleet, 4, "gloo", LAUNCH_S,
                                args=(case,))
    return got, _reference(jcfg, jparams)


def test_a_fleet_under_the_mesh_routes_and_decodes_as_the_reference(
        fleet_run):
    got, ref = fleet_run
    r = got[0]["mesh"]["result"]
    assert r == ref["mesh"]
    # both replicas took jobs, by load and by affinity
    assert {d["replica"] for d in r["decisions"]} == {0, 1}
    assert {d["leg"] for d in r["decisions"]} == {"load", "affinity"}


def test_every_replica_under_the_mesh_holds_its_dp_tp_shard(fleet_run):
    """Each replica's engine spans the whole mesh: one slot per dp rank,
    the heads split over tp on every rank."""
    got, _ = fleet_run
    for r in got:
        for idx in (0, 1):
            assert r["mesh"]["shards"][idx] == {
                "member": True, "pool": (2, 17, 8, 1, 16), "pos": (1,),
                "wqkv": (2, 32, 3, 1, 16)}


def test_replicas_over_rank_pairs_route_and_decode_as_the_reference(
        fleet_run):
    got, ref = fleet_run
    r = got[0]["subsets"]["result"]
    assert r["first"] == ref["subsets"]["first"]
    assert {d["replica"] for d in r["first"]["decisions"]} == {0, 1}


def test_each_rank_holds_only_its_pairs_shard(fleet_run):
    """Replica 0 lives on ranks 0 and 1, replica 1 on ranks 2 and 3 (a
    2×1 dp mesh: one slot per rank, every head); rank 0 drives replica 1
    holding none of its state, and ranks 2 and 3 hold nothing of
    replica 0."""
    got, _ = fleet_run
    whole = {"member": True, "pool": (2, 17, 8, 2, 16), "pos": (1,),
             "wqkv": (2, 32, 3, 2, 16)}
    none = {"member": False, "pool": False, "pos": False, "wqkv": False}
    shards = [r["subsets"]["shards"] for r in got]
    assert shards[0] == {0: whole, 1: none}
    assert shards[1] == {0: whole}
    assert shards[2] == shards[3] == {1: whole}


def test_a_replica_attached_past_the_subsets_takes_the_default_placement(
        fleet_run):
    got, ref = fleet_run
    r = got[0]["subsets"]["result"]
    assert r["attached"] == {"idx": ref["subsets"]["idx"], "mesh": False,
                             "device": "cpu"}
    assert r["second"] == ref["subsets"]["second"]


def test_a_driver_without_a_shard_runs_the_host_tier(fleet_run):
    """Replica 0 of the tier scenario lives on ranks 2 and 3 and takes
    the tier families: rank 0's store spills and restores its blocks
    through plans, sized by the block bytes rank 2 reported (tp 1: a
    whole block, replica 1's, whose shard rank 0 holds), and its memory
    ledger is rank 2's shard's; the tokens are the reference's."""
    got, ref = fleet_run
    r = got[0]["tier"]["result"]
    assert r["jobs"] == ref["mesh"]["tokens"]
    assert r["families"] == ref["families"]
    remote, local = r["replicas"]
    assert remote["spills"] > 0 and remote["restores"] > 0
    assert remote["block_nbytes"] == local["block_nbytes"] > 0
    assert remote["memory"] == local["memory"]
    assert remote["memory"]["kv_pool"] > 0
    assert got[0]["tier"]["shards"][0]["member"] is False
    assert got[2]["tier"]["shards"][0]["member"] is True


def test_a_drain_restart_attach_and_crash_fail_no_stream(fleet_run):
    got, ref = fleet_run
    r = got[0]["lifecycle"]["result"]
    assert r["failed"] == []
    assert r["drained"] is True and r["restarted"] == [True, True]
    assert r["mid_drain"] == ref["long"]
    assert r["after"] == ref["mesh"]["tokens"]
    assert r["attached"] == 2 and r["replicas"] == 3
    assert r["restarts"] == [0, 1, 0]


def test_every_follower_rebuilds_each_replica_with_rank_0(fleet_run):
    """Replica ``on`` was drained, every replica restarted, replica 2
    attached and replica 1 crashed: each follower built every engine rank
    0 built, and counts replica 1's rebuild after its failure."""
    got, _ = fleet_run
    on = got[0]["lifecycle"]["result"]["on"]
    want = {0: 2, 1: 3, 2: 1}
    want[on] += 1
    for r in got[1:]:
        followed = r["lifecycle"]["followed"]
        assert {i: row["builds"] for i, row in followed.items()} == want
        assert [followed[i]["restarts"] for i in (0, 1, 2)] == [0, 1, 0]
        assert not any(row["crash_looped"] for row in followed.values())


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_every_rank_reads_the_same_plans_in_the_same_order(fleet_run,
                                                           scenario):
    got, _ = fleet_run
    log = got[0][scenario]["log"]
    assert len(log) > 0
    assert all(r[scenario]["log"] == log for r in got[1:])


def test_the_fleets_lifecycle_rides_the_channel(fleet_run):
    """The plans that order the process groups ride the channel: every
    build of a replica's engine (the first replicas' too), each engine's
    end (its stop, or replica 1's failure, rebuilt after it) and the
    fleet's stop last."""
    got, _ = fleet_run
    ops = got[0]["lifecycle"]["log"]
    on = got[0]["lifecycle"]["result"]["on"]
    builds = {0: 2, 1: 3, 2: 1}
    builds[on] += 1
    assert ops[:2] == [(0, "build"), (1, "build")]
    for idx, n in builds.items():
        assert ops.count((idx, "build")) == n
        ends = ops.count((idx, "stop")) + ops.count((idx, "fail"))
        assert ends == n
    assert ops.count((1, "fail")) == 1
    assert ops.index((1, "fail")) < len(ops) - 1 - ops[::-1].index(
        (1, "build"))
    assert ops[-1] == (None, "stop")


def test_a_driver_without_a_shard_samples_device_time(fleet_run):
    """The tier scenario samples every dispatch synchronously: rank 0
    waits on replica 0's samples through rank 2 while fetches of its ring
    are still in flight, and every stream ends with the reference's
    tokens."""
    got, ref = fleet_run
    r = got[0]["tier"]["result"]
    assert r["jobs"] == ref["mesh"]["tokens"]
    remote, local = r["replicas"]
    assert remote["sampled"] > 0 and local["sampled"] > 0
    assert remote["blocks"] == remote["sampled"]


def test_integer_indices_name_gloo_ranks_with_a_card_visible(fleet_run):
    """On gloo ranks an index i names rank i's CPU even where the process
    sees cards (``torch.cuda.device_count`` stubbed to 2)."""
    got, _ = fleet_run
    for r in got:
        assert r["indices"] == {
            "(0, 1)": ([0, 1], "cpu"), "(2, 3)": ([2, 3], "cpu"),
            "(3, 0)": ([3, 0], "cpu"), "(1,)": "cpu:1"}


def test_autoscale_steps_decide_as_the_reference(fleet_run):
    got, ref = fleet_run
    r = got[0]["autoscale"]["result"]
    assert r == ref["autoscale"]
    actions = [[d["action"] for d in step] for step in r["steps"]]
    assert actions == [[], ["scale_up"], [], ["scale_down"]]
    assert r["replicas"] == [0]
    # the attached replica was built on every rank, and detached
    for g in got[1:]:
        assert g["autoscale"]["followed"][1]["builds"] == 1
