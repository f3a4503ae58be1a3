"""Training under a mesh (``repro_torch.training`` with a sharding policy),
held on the CPU on gloo meshes of several processes against the port's own
unsharded train step.

Each rank draws the same seeded params, places them and the optimizer
state by the policy (``init_train_state(..., policy=)``: ``shard_params``,
``shard_opt_state``) and the batch by its ``data_spec``, and takes
``STEPS`` steps of ``make_train_step`` under the mesh context.  The
unsharded run is the same code on plain tensors in the test process.

Meshes (1, 2), (2, 1) and (2, 2) (``RankPool(device="cpu")``, one pool of
2 and one of 4 ranks for the module).  Cases: smoke OLMo-1B (AdamW, the
non-parametric LayerNorm), smoke Qwen3-30B-A3B (experts sharded over
``model``, the router's aux loss), smoke Whisper at accum 2 (each
microbatch the global batch's contiguous rows, split over the batch axes;
the encoder and its cross K/V), smoke Qwen3-30B-A3B at accum 2 with a
loss mask that keeps more tokens in the first microbatch than in the
second (the router's aux loss and the masked mean are not linear in the
rows, so a microbatch of other rows gives another step), smoke OLMo-1B under Adafactor (factored second moments) on (2, 2),
and smoke Qwen3-30B-A3B under FSDP over the experts' hidden dim
(``moe_fsdp_dim="ff"``: each rank's share of the hidden units, a partial
sum) on (2, 2).  Compute and params in fp32.

Tolerances (fp32: the sharded step sums the same products in other
orders; measured differences are ~1e-7 relative):
  * loss and grad_norm at each step: 1e-5 relative;
  * the optimizer state after the last step, leaf by leaf (AdamW's first
    and second moments carry every gradient; Adafactor's factored
    moments its squares): 1e-4 of the leaf's largest magnitude;
  * every param entry: 2.02 x the summed learning rate (Adam's update of
    an entry whose gradient sits in the rounding noise may take either
    sign, at most 1.001 lr a step over these steps; the moments above
    hold the gradients themselves);
  * every optimizer-state leaf keeps the placement
    ``opt_state_shardings`` gives it, after every step.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch.ranks import RankPool

STEPS, BATCH, SEQ, LR = 2, 8, 32, 1e-3
CASES = {
    "olmo": dict(arch="olmo_1b", accum=1),
    "moe": dict(arch="qwen3_moe_30b_a3b", accum=1),
    "whisper": dict(arch="whisper_medium", accum=2),
    "moe_mask": dict(arch="qwen3_moe_30b_a3b", accum=2, mask=True),
    "adafactor": dict(arch="olmo_1b", accum=1, optimizer="adafactor"),
    "moe_ff": dict(arch="qwen3_moe_30b_a3b", accum=1, fsdp=True, moe_fsdp_dim="ff"),
}
RUNS = [(case, mesh) for case in ("olmo", "moe", "whisper") for mesh in ((1, 2), (2, 1), (2, 2))]
RUNS += [("moe_mask", (2, 1)), ("moe_mask", (2, 2))]
RUNS += [("adafactor", (2, 2)), ("moe_ff", (2, 2))]


def _cfg(case: str):
    c = CASES[case]
    cfg = dataclasses.replace(get_smoke_config(c["arch"]), dtype="float32",
                              param_dtype="float32")
    fields = {k: v for k, v in c.items() if k not in ("arch", "accum", "mask")}
    return dataclasses.replace(cfg, **fields)


def _batch(cfg, mask: bool = False) -> dict:
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g, dtype=torch.int32)
    out = {"tokens": tokens, "labels": tokens.clone()}
    if mask:  # row r keeps its first (BATCH - r) * SEQ / BATCH tokens: the two
        # halves keep 104 and 40, rows {0, 1, 4, 5} would keep 88
        keep = (BATCH - torch.arange(BATCH))[:, None] * (SEQ // BATCH)
        out["mask"] = (torch.arange(SEQ)[None, :] < keep).to(torch.int32)
    if cfg.frontend == "audio":
        out["frame_embeds"] = torch.randn(BATCH, cfg.encoder_seq_len, cfg.d_model, generator=g)
    return out


def _numpy(tree) -> dict:
    from repro_torch.sharding.ctx import plain
    from repro_torch.sharding.policy import tree_paths

    return {p: plain(t).detach().numpy().copy() for p, t in tree_paths(tree)}


def train(case: str, mesh_shape=None) -> dict:
    """``STEPS`` steps of the case from the seed-0 state: per-step loss and
    grad_norm, the params and optimizer state after the last step (whole,
    as numpy), and the optimizer-state leaves found out of place."""
    from repro_torch.models.model import init_params
    from repro_torch.sharding.ctx import mesh_context, plain
    from repro_torch.sharding.policy import distribute, make_policy, placements, spec_at
    from repro_torch.sharding.policy import tree_paths
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.train_loop import init_train_state, make_train_step

    cfg = _cfg(case)
    opt = make_optimizer(cfg.optimizer, lr=LR)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg, CASES[case].get("mask", False))
    step = make_train_step(cfg, opt, accum=CASES[case]["accum"])
    out = {"loss": [], "grad_norm": [], "misplaced": []}
    if mesh_shape is None:
        state = init_train_state(params, opt)
        for _ in range(STEPS):
            state, m = step(state, batch)
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
    else:
        from repro_torch.launch.mesh import make_local_mesh

        mesh = make_local_mesh(data=mesh_shape[0], model=mesh_shape[1], device="cpu")
        pol = make_policy(mesh, cfg)
        state = init_train_state(params, opt, policy=pol)
        batch = {k: distribute(v, mesh, pol.data_spec(tuple(v.shape)))
                 for k, v in batch.items()}
        specs = pol.opt_state_shardings(state["params"], cfg.optimizer)
        for _ in range(STEPS):
            with mesh_context(pol.mesh, pol.batch_axes):
                state, m = step(state, batch)
            out["loss"].append(float(plain(m["loss"])))
            out["grad_norm"].append(float(plain(m["grad_norm"])))
            out["misplaced"] += [p for p, t in tree_paths(state["opt"])
                                 if list(t.placements) != placements(spec_at(specs, p), mesh)]
        out["shard_leaves"] = sum(any(q.is_shard() for q in t.placements)
                                  for _, t in tree_paths(state["opt"]))
    out["params"] = _numpy(state["params"])
    out["opt"] = _numpy(state["opt"])
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pools():
    with RankPool(2, device="cpu") as two, RankPool(4, device="cpu") as four:
        yield {2: two, 4: four}


@pytest.fixture(scope="module")
def unsharded():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = train(case)
        return cache[case]

    return get


@pytest.mark.parametrize("case,mesh", RUNS, ids=[f"{c}-{m[0]}x{m[1]}" for c, m in RUNS])
def test_sharded_train_step_matches_unsharded(pools, unsharded, case, mesh):
    base = unsharded(case)
    ranks = pools[mesh[0] * mesh[1]].run(train, case, mesh)
    got = ranks[0]
    for r in ranks[1:]:
        assert r["loss"] == got["loss"] and r["grad_norm"] == got["grad_norm"]
    np.testing.assert_allclose(got["loss"], base["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], base["grad_norm"], rtol=1e-5)
    assert got["misplaced"] == [], got["misplaced"][:5]
    if mesh[1] > 1:
        assert got["shard_leaves"] > 0
    for path, want in base["opt"].items():
        scale = float(np.abs(want).max()) or 1.0
        np.testing.assert_allclose(got["opt"][path], want, rtol=0, atol=1e-4 * scale,
                                   err_msg=path)
    bound = 2.02 * LR * STEPS
    for path, want in base["params"].items():
        np.testing.assert_allclose(got["params"][path], want, rtol=0, atol=bound,
                                   err_msg=path)
