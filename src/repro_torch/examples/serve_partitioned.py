"""End-to-end driver: serve a small BranchyNet LM with batched requests
across tier splits, re-optimizing the partition as network conditions
change — counterpart of ``examples/serve_partitioned.py``, step for step.

The paper's deployment story: the cost model + Dijkstra run in the control
plane at admission time and whenever bandwidth drifts; the data plane
executes the installed split.  Beyond the paper, the same runtime executes
a K=3 lattice plan (device -> edge -> cloud) with per-hop byte accounting,
pipelines the simulated transfers with compute, serves a request stream
with continuous batching, and survives a killed link: the circuit breaker
opens, rows finalize from the deepest exit head below the broken hop, and
the controller moves the cut off the sick link.

    python -m repro_torch.examples.serve_partitioned [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import LayerCost, Partitioner, build_cost_profile
from repro_torch.core.multitier import TierSpec, solve_multitier
from repro_torch.core.types import NetworkProfile
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import model as M
from repro_torch.serving import (
    FlapWindow,
    HopPolicy,
    LinkFaultModel,
    MultiTierServer,
    PartitionedServer,
    RepartitionController,
    RequestScheduler,
    ServingEngine,
)
from repro_torch.serving.tiers import bytes_per_sequence

__all__ = ["main"]

BATCH = 16
PROMPT = 24
CONTEXT = 256
DECODE_STEPS = 16

#: The paper's regime: the raw input sample (an image) dwarfs any layer's
#: output, so cuts past the first layers pay off on slow uplinks.  For the
#: LM stand-in a vision-style 32 KiB admission payload.
RAW_INPUT_BYTES = 32 * 1024.0

#: Bandwidth schedule the "deployment" experiences (bits/s).
NETWORK_SCHEDULE = [
    ("wifi", 18.8e6),
    ("4g", 5.85e6),
    ("degraded-3g", 0.4e6),
]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cpu, or a CUDA device (default: the current one)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = dataclasses.replace(get_smoke_config("qwen3_8b"), num_layers=4,
                              branch_layers=(1, 3))
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    n = cfg.num_layers
    rng = np.random.default_rng(0)
    print(f"serving {cfg.name} (reduced): {n} layers, branches "
          f"{cfg.branch_layers}; device {device}")

    # ---- calibration pass on the unpartitioned engine (K=1 runtime).
    engine = ServingEngine(cfg, params, context_len=CONTEXT, device=device)
    state = engine.start({"tokens": rng.integers(0, cfg.vocab_size, (BATCH, PROMPT))})
    _, stats = engine.decode(state, steps=8)
    p_k = stats.conditional_probs()
    print(f"calibrated p_k = {np.round(p_k, 3)} "
          f"(fractions {np.round(stats.exit_fractions(), 3)}), "
          f"{engine.host_syncs} host syncs for 8 decode steps")

    # ---- per-layer costs (a uniform stub; a deployment measures them with
    # core.profiler.measure_layer_times on the edge and cloud tiers).
    costs = [LayerCost(f"block{i}", 0, 0, cfg.d_model * 2.0, 1.5e-3)
             for i in range(1, n + 1)]

    # ---- the paper's system: 2 tiers, repartitioned as bandwidth drifts;
    # set_split reuses the cached segments of any split installed before.
    srv = PartitionedServer(cfg, params, 0, device=device)
    for net_name, bw in NETWORK_SCHEDULE:
        profile = build_cost_profile(
            costs, cfg.branch_layers, p_k,
            network=NetworkProfile(net_name, bw),
            gamma=25.0, raw_input_bytes=RAW_INPUT_BYTES,
        )
        plan = Partitioner(profile).solve()
        srv.cost_profile = profile
        srv.set_split(plan.split_layer)
        print(f"\n== network {net_name} ({bw / 1e6:.2f} Mbps) -> {plan.describe()}")

        caches = M.init_caches(cfg, BATCH, CONTEXT, device=device)
        tok = np.zeros((BATCH, 1), np.int32)
        shipped = edge_exits = 0
        t0 = time.perf_counter()
        for i in range(DECODE_STEPS):
            rep, caches = srv.step(tok, PROMPT + i, caches)
            tok = rep.tokens[:, None]
            shipped += rep.shipped
            edge_exits += int(rep.exited_on_edge.sum())
        dt = time.perf_counter() - t0
        total = BATCH * DECODE_STEPS
        est = 0.0 if rep.est_latency_s is None else rep.est_latency_s * 1e3
        print(f"   decoded {total} token-steps in {dt:.2f}s: {edge_exits} exited "
              f"on edge, {shipped} crossed the cut "
              f"({(1 - shipped / total) * 100:.0f}% transfer saved), "
              f"model-estimated E[T]={est:.2f} ms/sample")

    # ---- beyond the paper: a K=3 lattice plan on the same runtime.
    tiers = [
        TierSpec("device", 60.0, uplink_bps=18.8e6),  # wifi to the edge box
        TierSpec("edge", 12.0, uplink_bps=1.10e6),  # 3g backhaul to the cloud
        TierSpec("cloud", 1.0),
    ]
    profile = build_cost_profile(costs, cfg.branch_layers, p_k, "3g", 25.0,
                                 RAW_INPUT_BYTES)
    plan3 = solve_multitier(profile.t_c, profile.alpha, profile.branch_exit_probs(),
                            tiers)
    print(f"\n== K=3 lattice plan: cuts after {plan3.cut_after}, tier_of_layer "
          f"{plan3.tier_of_layer}, E[T]={plan3.expected_time_s * 1e3:.2f} ms")
    srv3 = MultiTierServer.from_plan(cfg, params, plan3, tiers,
                                     cost=(profile.t_c, profile.alpha), device=device)
    caches = M.init_caches(cfg, BATCH, CONTEXT, device=device)
    tok = np.zeros((BATCH, 1), np.int32)
    hop_bytes = np.zeros(len(tiers) - 1)
    hop_shipped = np.zeros(len(tiers) - 1, int)
    for i in range(DECODE_STEPS):
        rep3, caches = srv3.step(tok, PROMPT + i, caches)
        tok = rep3.tokens[:, None]
        for j in range(len(rep3.bytes_per_hop)):
            hop_bytes[j] += rep3.bytes_per_hop[j]
            hop_shipped[j] += rep3.shipped_per_hop[j]
    # Per-hop bytes match the installed plan: every survivor crossing hop j
    # carries the residual stream of the cut layer (alpha_{c_j}; a cut
    # before layer 1 ships the 4-byte token id).
    for j, cut in enumerate(srv3.cuts[: len(rep3.bytes_per_hop)]):
        per_seq = bytes_per_sequence(cfg, cut)
        assert hop_bytes[j] == hop_shipped[j] * per_seq
        if cut > 0:
            assert per_seq == profile.alpha[cut]
        print(f"   hop {tiers[j].name}->{tiers[j + 1].name} (cut after v_{cut}): "
              f"{hop_shipped[j]} survivors, {hop_bytes[j] / 1024:.1f} KiB over "
              f"{tiers[j].uplink_bps / 1e6:.2f} Mbps (matches plan alpha)")
    print(f"   last step est E[T]={rep3.est_latency_s * 1e3:.2f} ms/sample, exit "
          f"tiers {np.bincount(rep3.exit_tier + 1, minlength=len(tiers) + 1)}")
    for j, hop in enumerate(rep3.compaction):
        print(f"   hop {j}: {hop.survivors} survivors -> bucket {hop.bucket} "
              f"({hop.padded_waste} padding rows), "
              f"{srv3.executor.overflow_retries} overflow retries total")

    # ---- pipelined overlap: serial pays compute + every hop's transfer per
    # step; pipelined overlaps the transfers with the next step, so the
    # steady step is the slowest stage.  The best cut can move under
    # overlap: re-solve with overlap=True before installing.
    plan3o = solve_multitier(profile.t_c, profile.alpha, profile.branch_exit_probs(),
                             tiers, overlap=True)
    print(f"\n== pipelined K=3: serial plan cuts {plan3.cut_after} "
          f"(E[T] {plan3.expected_time_s * 1e3:.2f} ms) vs overlap plan cuts "
          f"{plan3o.cut_after} (E[T]/step {plan3o.expected_time_s * 1e3:.2f} ms)")
    per_seq = bytes_per_sequence(cfg, 2)
    sim_tiers = [  # ~35 ms / ~20 ms per-hop transfers at full batch
        TierSpec("device", 60.0, per_seq * BATCH * 8.0 / 0.035),
        TierSpec("edge", 12.0, per_seq * BATCH * 8.0 / 0.020),
        TierSpec("cloud", 1.0),
    ]
    step_ms = {}
    for overlap in ("serial", "pipelined"):
        srvp = MultiTierServer(cfg, params, sim_tiers, (2, 3),
                               cost=(profile.t_c, profile.alpha),
                               simulate_network=True, overlap=overlap, device=device)
        caches = M.init_caches(cfg, BATCH, CONTEXT, device=device)
        tok = np.zeros((BATCH, 1), np.int32)
        repp, caches = srvp.step(tok, PROMPT, caches)  # first use of each key
        tok = repp.tokens[:, None]
        srvp.executor.drain()  # do not time the first step's transfers
        t0 = time.perf_counter()
        for i in range(1, DECODE_STEPS):
            repp, caches = srvp.step(tok, PROMPT + i, caches)
            tok = repp.tokens[:, None]
        srvp.executor.drain()  # the trailing transfers in flight
        dt = (time.perf_counter() - t0) / (DECODE_STEPS - 1)
        step_ms[overlap] = dt * 1e3
        print(f"   {overlap:<9} {dt * 1e3:7.1f} ms/step (sim transfers "
              f"{tuple(round(s * 1e3) for s in repp.sim_transfer_s)} ms, "
              f"est E[T]/step {repp.est_latency_s * 1e3:.2f} ms)")

    # ---- continuous batching on the K=3 plan: staggered arrivals, mixed
    # prompt lengths and budgets through submit() / drain(); finished and
    # early-exited requests retire mid-flight and waiting prompts prefill
    # into the freed KV rows.
    srvr = MultiTierServer(cfg, params, tiers, plan3.cut_after,
                           cost=(profile.t_c, profile.alpha), slots=6,
                           context_len=CONTEXT, device=device)
    rids = []
    for i in range(10):
        plen = int(rng.choice((8, 16)))
        prompt = rng.integers(0, cfg.vocab_size, size=plen)
        rids.append(srvr.submit(prompt, int(rng.integers(3, 10)),
                                stop_on_exit=bool(i % 2), arrival_step=i))
    results = srvr.drain()
    sched = srvr.scheduler
    print(f"\n== continuous batching on the K=3 plan: {len(results)} requests over "
          f"{sched.decode_steps} decode steps ({sched.executor.host_syncs} host "
          f"syncs), 6 slots")
    for r in results:
        print(f"   req {r.rid}: slot {r.slot}, admitted step {r.admitted_step}, "
              f"{len(r.tokens)} tokens, exits {sum(r.exited)}, TTFT "
              f"{r.ttft_s * 1e3:.0f} ms, latency {r.latency_s * 1e3:.0f} ms")
    # Every request finished, decoded at least one token within budget, and
    # its latency is at least its TTFT.
    assert len(results) == len(rids)
    for rid in rids:
        r = sched.results[rid]
        assert r.done and 1 <= len(r.tokens)
        assert r.ttft_s is not None and 0 < r.ttft_s <= r.latency_s
        assert r.retired_step > r.admitted_step >= 0
    # 10 requests over 6 slots: at least one KV row served two occupants.
    slot_uses = np.bincount([r.slot for r in results], minlength=6)
    assert slot_uses.max() >= 2, "expected a recycled slot"
    print(f"   slot reuse histogram {slot_uses.tolist()}: recycled rows served "
          f"later arrivals")

    # ---- the fault plane: a link killed mid-run.  A scripted flap takes
    # the mid->cloud hop down; retries exhaust, the circuit breaker opens,
    # and survivors finalize from the deepest exit head below the broken
    # hop (tokens still emit, flagged degraded).  The controller takes the
    # breaker event and re-solves with the hop's availability at 0: the new
    # cuts ship nothing across it.
    fault_tiers = [
        TierSpec("edge", 12.0, uplink_bps=18.8e6),
        TierSpec("mid", 4.0, uplink_bps=5.85e6),
        TierSpec("cloud", 1.0),
    ]
    srvf = MultiTierServer(
        cfg, params, fault_tiers, (1, 3), simulate_network=True, slots=6,
        context_len=CONTEXT, device=device,
        fault_model=LinkFaultModel(
            seed=0, flaps=(FlapWindow(hop=1, start_step=6, end_step=10_000),)),
        hop_policy=HopPolicy(timeout_s=0.02, max_retries=1, backoff_s=0.002,
                             breaker_threshold=2),
    )
    ctl = RepartitionController(srvf, profile, tiers=list(fault_tiers))
    schedf = RequestScheduler(srvf, 6, CONTEXT, on_step=[ctl.observe])
    for i in range(10):
        plen = int(rng.choice((8, 16)))
        schedf.submit(rng.integers(0, cfg.vocab_size, size=plen),
                      int(rng.integers(3, 10)), arrival_step=i)
    resultsf = schedf.drain()
    deg = sum(r.degraded_tokens for r in resultsf)
    print(f"\n== fault plane: hop mid->cloud killed at step 6 — {len(resultsf)} "
          f"requests still completed ({deg}/{schedf.total_tokens} tokens degraded "
          f"via the fallback head, {srvf.executor.fault_retries} retries)")
    print(f"   controller: {ctl.fault_resolves} availability re-solve(s), cuts now "
          f"{srvf.cuts}, hop health {ctl.hop_health()}")
    assert all(r.done for r in resultsf)
    assert ctl.fault_resolves >= 1 and srvf.cuts[1] == cfg.num_layers
    print("   every request completed despite the dead link")
    return dict(p_k=p_k, k3_cuts=srv3.cuts, step_ms=step_ms,
                fault_cuts=srvf.cuts, fault_resolves=ctl.fault_resolves,
                degraded_tokens=deg, host_syncs=sched.executor.host_syncs)


if __name__ == "__main__":
    main()
