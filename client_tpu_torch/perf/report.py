"""Report rendering: stdout summary + CSV export — the port's copy of
``client_tpu/perf/report.py``.

The text is the reference's, block for block: the client's and the
server's numbers, the ``/metrics`` blocks (runtime, watchdog, SLO, fleet,
scheduler, generation, lanes, tier, prefix cache, speculation) and the
"Goodput / device time" roofline block, whose MFU is the server's own
gauge (its denominator is the card's peak from
``bench_harness.CARD_PEAKS``; absent on the CPU and on a card without
published peaks). The runtime block is headed "compiles/HBM", as the
port has no XLA. The CSV schema is the reference's.
"""

from __future__ import annotations

import csv
import io


def _fmt_us(us: float) -> str:
    return f"{us:.0f} usec"


def render_report(results: list, parser, mode: str = "concurrency",
                  include_server: bool = True) -> str:
    out = io.StringIO()
    w = out.write
    w(f"*** Measurement Settings ***\n")
    w(f"  Model: {parser.model_name}\n")
    for status in results:
        label = (f"Concurrency: {status.concurrency}"
                 if mode == "concurrency"
                 else f"Request Rate: {status.request_rate:g}")
        w(f"\n{label}\n")
        if not status.stabilized:
            w("  [WARNING] measurement did not stabilize\n")
        w(f"  Client:\n")
        w(f"    Request count: {status.valid_count}\n")
        if status.delayed_count:
            w(f"    Delayed Request Count: {status.delayed_count}\n")
        w(f"    Throughput: {status.client_infer_per_sec:.2f} infer/sec\n")
        if status.client_sequence_per_sec:
            w(f"    Sequence Throughput: "
              f"{status.client_sequence_per_sec:.2f} seq/sec\n")
        lat = status.latency
        w(f"    Avg latency: {_fmt_us(lat.avg_us)} "
          f"(standard deviation {_fmt_us(lat.std_us)})\n")
        for p, v in sorted(lat.percentiles_us.items()):
            w(f"    p{p} latency: {_fmt_us(v)}\n")
        if status.client_rejected_count:
            w(f"    Rejected count (client): "
              f"{status.client_rejected_count}\n")
        if status.client_retried_count:
            w(f"    Retried count (client): "
              f"{status.client_retried_count}\n")
        if include_server and status.server.inference_count:
            s = status.server
            w(f"  Server:\n")
            w(f"    Inference count: {s.inference_count}\n")
            w(f"    Execution count: {s.execution_count}\n")
            if s.cache_hit_count:
                w(f"    Cache hit count: {s.cache_hit_count}\n")
            if s.rejected_count:
                w(f"    Rejected count: {s.rejected_count}\n")
            w(f"    Queue: {_fmt_us(s.queue_time_us)}\n")
            w(f"    Compute input: {_fmt_us(s.compute_input_time_us)}\n")
            w(f"    Compute infer: {_fmt_us(s.compute_infer_time_us)}\n")
            w(f"    Compute output: {_fmt_us(s.compute_output_time_us)}\n")
            for name, cs in s.composing_models.items():
                w(f"    Composing model {name}: infer "
                  f"{_fmt_us(cs.compute_infer_time_us)}, queue "
                  f"{_fmt_us(cs.queue_time_us)}\n")
        m = status.metrics
        if include_server and m.scraped:
            w(f"  Server metrics (/metrics):\n")
            w(f"    Batches/sec: {m.batches_per_sec:.2f}\n")
            w(f"    Inferences/sec: {m.inferences_per_sec:.2f}\n")
            w(f"    Queue depth p50/max: {m.queue_depth_p50:.0f}/"
              f"{m.queue_depth_max:.0f}\n")
            if m.cache_hits or m.cache_misses:
                w(f"    Cache hit rate: {100.0 * m.cache_hit_rate:.1f}% "
                  f"({m.cache_hits} hit / {m.cache_misses} miss)\n")
        if include_server and m.runtime_scraped:
            w(f"  Runtime (compiles/HBM):\n")
            w(f"    Compiles in window: {m.runtime_compiles} "
              f"({m.runtime_unexpected_compiles} unexpected — a warmed "
              f"server must show 0)\n")
            if m.runtime_warmup_compiles:
                w(f"    Warmup compile cost: "
                  f"{m.runtime_warmup_compiles} compiles in "
                  f"{m.runtime_warmup_compile_s:.1f}s (sealed-set "
                  f"size — bucket grids and the gamma ladder "
                  f"multiply it)\n")
            if m.hbm_bytes_limit > 0:
                w(f"    HBM in use: {m.hbm_bytes_in_use / 2**20:.1f} MiB "
                  f"/ {m.hbm_bytes_limit / 2**20:.1f} MiB (headroom "
                  f"{m.hbm_headroom_bytes / 2**20:.1f} MiB)\n")
            pool_total = (m.hbm_pool_live_bytes + m.hbm_pool_prefix_bytes
                          + m.hbm_pool_free_bytes)
            if pool_total > 0:
                w(f"    KV pool (paged): "
                  f"{m.hbm_pool_live_bytes / 2**20:.1f} MiB live / "
                  f"{m.hbm_pool_prefix_bytes / 2**20:.1f} MiB prefix / "
                  f"{m.hbm_pool_free_bytes / 2**20:.1f} MiB free\n")
        if include_server and m.watchdog_scraped:
            w(f"  Watchdog:\n")
            w(f"    Incidents in window: {m.watchdog_incident_count} "
              f"({m.watchdog_samples} detector samples; a healthy "
              f"steady-state run must show 0 incidents)\n")
            for det, n in sorted(m.watchdog_incidents.items()):
                w(f"      {det}: {n}\n")
            if m.watchdog_ring_depth > 0:
                w(f"    Incident ring depth: "
                  f"{m.watchdog_ring_depth:.0f} bundle(s) held "
                  f"(GET /v2/debug/incidents)\n")
        if include_server and m.slo_scraped:
            w(f"  SLO (per tenant, windowed):\n")
            for (tenant, cls), row in sorted(m.slo_tenants.items()):
                w(f"    {tenant}/{cls}: TTFT p50/p95/p99 "
                  f"{_fmt_us(row['ttft_p50_s'] * 1e6)} / "
                  f"{_fmt_us(row['ttft_p95_s'] * 1e6)} / "
                  f"{_fmt_us(row['ttft_p99_s'] * 1e6)}, "
                  f"ITL p95 {_fmt_us(row['inter_token_p95_s'] * 1e6)}, "
                  f"burn {row['burn_rate']:.2f}, "
                  f"{row['requests']} completed / "
                  f"{row['shed']} shed\n")
        if include_server and m.fleet_scraped:
            w(f"  Fleet (replica router):\n")
            w(f"    Replicas: {m.fleet_healthy:.0f}/"
              f"{m.fleet_replicas:.0f} healthy, queue "
              f"{m.fleet_queue_depth:.0f} across replicas at window "
              f"end\n")
            w(f"    Routed in window: {m.fleet_routed} "
              f"({m.fleet_affinity_hits} affinity hits, "
              f"{m.fleet_rerouted} re-routed, {m.fleet_drains} "
              f"drain-swaps)\n")
        if include_server and m.sched_scraped:
            w(f"  Scheduler (closed-loop):\n")
            w(f"    Preemptions/resumes in window: "
              f"{m.sched_preemptions}/{m.sched_resumes}, fair queue "
              f"{m.sched_queue_depth:.0f} at window end\n")
            w(f"    Knobs at window end: prefill budget "
              f"{m.sched_prefill_budget:.0f}, fetch stride "
              f"{m.sched_fetch_stride:.0f}, duty "
              f"{m.sched_dispatch_duty:.2f}, speculation "
              f"{'on' if m.sched_spec_enabled else 'off'}\n")
        g = status.generation
        if g.enabled:
            w(f"  Generation (token stream):\n")
            w(f"    Tokens: {g.token_count} "
              f"({g.tokens_per_sec:.2f} tokens/sec client-observed)\n")
            w(f"    TTFT avg: {_fmt_us(g.ttft_avg_us)}\n")
            for p, v in sorted(g.ttft_percentiles_us.items()):
                w(f"    TTFT p{p}: {_fmt_us(v)}\n")
            if g.itl_percentiles_us:
                w(f"    Inter-token avg: {_fmt_us(g.itl_avg_us)}\n")
                for p, v in sorted(g.itl_percentiles_us.items()):
                    w(f"    Inter-token p{p}: {_fmt_us(v)}\n")
            if include_server and m.generation_scraped:
                w(f"    Server tokens/sec: "
                  f"{m.generation_tokens_per_sec:.2f}\n")
                w(f"    Server slot occupancy: "
                  f"{100.0 * m.generation_slot_occupancy:.1f}%\n")
                if m.engine_phase_s:
                    w(f"    Engine retire share: "
                      f"{100.0 * m.engine_retire_share:.1f}% of phase "
                      f"wall (fetch "
                      f"{m.engine_phase_s.get('retire_fetch', 0.0):.2f}s"
                      f" / deliver "
                      f"{m.engine_phase_s.get('retire_deliver', 0.0):.2f}"
                      f"s)\n")
                if m.ring_fetches:
                    w(f"    Ring fetches: {m.ring_fetches} "
                      f"({m.ring_amortization:.1f} dispatches/fetch, "
                      f"{m.ring_forced_fetches} forced, lag "
                      f"{m.ring_lag_chunks:.0f} chunks at window end)\n")
                if m.prefill_chunks:
                    fill = m.prefill_tokens / m.prefill_chunks
                    w(f"    Prefill lane: {m.prefill_tokens} prompt "
                      f"tokens in {m.prefill_chunks} chunks "
                      f"({fill:.1f} tokens/chunk, "
                      f"{100.0 * m.engine_prefill_share:.1f}% of phase "
                      f"wall, queue {m.generation_queue_depth:.0f} at "
                      f"window end)\n")
            if include_server and m.lane_scraped:
                w(f"  Prefill lane (dedicated):\n")
                w(f"    Lane slots: {m.lane_active:.0f}/"
                  f"{m.lane_slots:.0f} active at window end, "
                  f"{m.lane_handoffs} handoffs in window "
                  f"(prefill disaggregated from decode — decode "
                  f"dispatches carry no ingesting prompts)\n")
            if include_server and m.tier_scraped:
                w(f"  KV tier (host RAM):\n")
                w(f"    Tier blocks: {m.tier_blocks:.0f} resident, "
                  f"{m.tier_spills} spills / {m.tier_restores} "
                  f"restores / {m.tier_hits} tier hits in window\n")
            if include_server and m.prefix_cache_scraped:
                w(f"    Prefix cache hit rate: "
                  f"{100.0 * m.prefix_hit_rate:.1f}% "
                  f"({m.prefix_hits} hit / {m.prefix_misses} miss)\n")
                w(f"    Prefix tokens saved: {m.prefix_saved_tokens} "
                  f"({m.prefix_evictions} evictions, "
                  f"{m.prefix_blocks_used} blocks used)\n")
            if include_server and m.spec_scraped:
                w(f"  Speculation:\n")
                w(f"    Acceptance rate: "
                  f"{100.0 * m.spec_acceptance_rate:.1f}% "
                  f"({m.spec_accepted} accepted / {m.spec_proposed} "
                  f"proposed, rolling {100.0 * m.spec_acceptance_gauge:.1f}%)\n")
                w(f"    Verify rounds: {m.spec_rounds} "
                  f"({m.spec_tokens_per_round:.2f} tokens/round — the "
                  f"draft-overhead efficiency)\n")
        if include_server and m.goodput_scraped:
            w(f"  Goodput / device time:\n")
            w(f"    Useful-FLOP share: "
              f"{100.0 * m.goodput_useful_flop_share:.1f}% over the "
              f"window ({m.goodput_useful_flops:.3g} useful / "
              f"{m.goodput_wasted_flops:.3g} wasted FLOPs)\n")
            if m.goodput_mfu_present:
                w(f"    MFU: {100.0 * m.goodput_mfu:.1f}% of device "
                  f"peak at window end\n")
            if m.goodput_sampling_share > 0:
                w(f"    Sync-sampled dispatches: "
                  f"{100.0 * m.goodput_sampling_share:.1f}% "
                  f"(bounded overhead mode)\n")
            dev_total = m.goodput_device_seconds
            useful_total = sum(
                m.goodput_kind_useful_flops.values()) or 1.0
            if dev_total > 0:
                # roofline-style split: where device time went vs
                # where useful FLOPs came from — a kind whose time
                # share dwarfs its useful-FLOP share is the waste
                w(f"    Kernel kind        device-time  useful-FLOP\n")
                for kind, secs in sorted(
                        m.goodput_device_s.items(),
                        key=lambda kv: -kv[1]):
                    uf = m.goodput_kind_useful_flops.get(kind, 0.0)
                    w(f"    {kind:<18s} "
                      f"{100.0 * secs / dev_total:>10.1f}%  "
                      f"{100.0 * uf / useful_total:>10.1f}%"
                      f"  ({m.goodput_dispatches.get(kind, 0)} "
                      f"dispatches)\n")
        if include_server and status.slowest_requests:
            w(f"  Slowest request breakdown (server traces):\n")
            for r in status.slowest_requests:
                total = max(r["total_us"], 1e-9)
                shares = ", ".join(
                    f"{label} {100.0 * r[field] / total:.0f}%"
                    for label, field in (
                        ("queue", "queue_us"),
                        ("prefill", "prefill_us"),
                        ("handoff", "handoff_us"),
                        ("decode", "decode_us"),
                        ("fetch", "fetch_us"))
                    if r[field] > 0)
                where = (f", replica {r['replica']} "
                         f"via {r['route_leg'] or '?'}"
                         if r["replica"] is not None else "")
                mark = " [exemplar]" if r.get("in_exemplars") else ""
                w(f"    {r['trace_id']}: {_fmt_us(r['total_us'])} "
                  f"({shares or 'no phase spans'}){where}{mark}\n")
    return out.getvalue()


def write_csv(path: str, results: list, parser,
              mode: str = "concurrency") -> None:
    """The reference's CSV schema."""
    key = "Concurrency" if mode == "concurrency" else "Request Rate"
    fields = [key, "Inferences/Second", "Client Send",
              "Network+Server Send/Recv", "Server Queue",
              "Server Compute Input", "Server Compute Infer",
              "Server Compute Output", "Client Recv"]
    pcts = sorted({p for r in results
                   for p in r.latency.percentiles_us})
    fields += [f"p{p} latency" for p in pcts]
    # sheds in the window, attributed separately: the client column
    # counts only rejections THIS client observed; the server column is
    # the server-wide stats delta (it includes other clients' sheds, so
    # folding it into one column would overstate the measuring client's)
    fields += ["Avg latency", "Client Rejected Count",
               "Server Rejected Count"]
    # per-(tenant, slo_class) reject/latency attribution from the SLO
    # scrape: one column triple per key seen in any result row, so a
    # multi-tenant run's CSV splits the server-wide reject count and
    # latency by who paid it
    slo_keys = sorted({key for r in results
                       for key in r.metrics.slo_tenants})
    for tenant, cls in slo_keys:
        fields += [f"Tenant {tenant}/{cls} Rejected Count",
                   f"Tenant {tenant}/{cls} p95 TTFT",
                   f"Tenant {tenant}/{cls} Burn Rate"]
    with open(path, "w", newline="") as f:
        cw = csv.writer(f)
        cw.writerow(fields)
        for r in results:
            s = r.server
            total_us = r.latency.avg_us
            server_us = (s.queue_time_us + s.compute_input_time_us +
                         s.compute_infer_time_us + s.compute_output_time_us)
            net_us = max(0.0, total_us - server_us)
            row = [
                r.concurrency if mode == "concurrency" else r.request_rate,
                f"{r.client_infer_per_sec:.2f}",
                0,
                f"{net_us:.0f}",
                f"{s.queue_time_us:.0f}",
                f"{s.compute_input_time_us:.0f}",
                f"{s.compute_infer_time_us:.0f}",
                f"{s.compute_output_time_us:.0f}",
                0,
            ]
            row += [f"{r.latency.percentiles_us.get(p, 0):.0f}"
                    for p in pcts]
            row += [f"{r.latency.avg_us:.0f}",
                    r.client_rejected_count, s.rejected_count]
            for key in slo_keys:
                t_row = r.metrics.slo_tenants.get(key)
                if t_row is None:
                    row += ["", "", ""]
                else:
                    row += [t_row["shed"],
                            f"{t_row['ttft_p95_s'] * 1e6:.0f}",
                            f"{t_row['burn_rate']:.3f}"]
            cw.writerow(row)
        # per-composing-model blocks (ensemble parity)
        composing = {name for r in results
                     for name in r.server.composing_models}
        for name in sorted(composing):
            cw.writerow([])
            cw.writerow([f"Composing model: {name}"])
            cw.writerow([key, "Server Queue", "Server Compute Input",
                         "Server Compute Infer", "Server Compute Output"])
            for r in results:
                cs = r.server.composing_models.get(name)
                if cs is None:
                    continue
                cw.writerow([
                    r.concurrency if mode == "concurrency"
                    else r.request_rate,
                    f"{cs.queue_time_us:.0f}",
                    f"{cs.compute_input_time_us:.0f}",
                    f"{cs.compute_infer_time_us:.0f}",
                    f"{cs.compute_output_time_us:.0f}"])
