"""Mesh-sharded tier segments in the port (``serving/tiers.py``, "Mesh-sharded
tier segments"), held on the CPU on a gloo mesh of several processes: the
cases of the reference's ``tests/test_sharded_tiers.py`` (whose multi-device
cases skip without virtual devices), with the port's sharded runs held
against the port's own unsharded runs on bridged reference weights.

The contract is the reference's: the token, exit-mask and shipped-count
trajectory of a sharded run equals the unsharded one step by step (logits
are not bitwise: partial sums reduce in another order), one host sync per
step on every rank, hot swaps that rebuild no unchanged sharded segment,
kernels resolved off, and at least one ``Shard``-placed leaf.

Meshes: 2 ranks as (1, 2), where ``model`` divides the smoke config's 2 KV
heads; 4 ranks as (1, 4), where the caches take the ``head_dim`` fallback
and K / V projections split a head; and (2, 2), which shards the batch.
Each world is one :class:`~repro_torch.launch.ranks.RankPool` for the
module (rendezvous through a file, no fixed port), one intra-op thread per
rank; the ranks load the weights once.  Fixtures: the ``qwen3_8b`` smoke
config at 4 layers with branches (1, 3) from ``PRNGKey(0)``, and the
``qwen3_moe_30b_a3b`` smoke config likewise from ``PRNGKey(1)``, bf16
compute as the reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch.ranks import RankPool

STEPS, BATCH, CTX = 4, 4, 32
DEEP = dict(num_layers=4, branch_layers=(1, 3))
FIXTURES = {"gqa": ("qwen3_8b", 0), "moe": ("qwen3_moe_30b_a3b", 1)}
SHARD_WIDTHS = {(1, 2): 2, (1, 4): 4, (2, 2): 4}

# ----------------------------------------------------------- on each rank
_WEIGHTS: dict = {}


def _cfg(name):
    return dataclasses.replace(get_smoke_config(FIXTURES[name][0]), **DEEP)


def _params(name):
    """The bridged reference weights as the port's CPU tensors."""
    leaves = _WEIGHTS[name]

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        arr, dtype = tree
        return torch.from_numpy(arr).to(getattr(torch, dtype))

    return build(leaves)


def _load(weights) -> bool:
    _WEIGHTS.update(weights)
    return True


def _mesh(shape):
    from repro_torch.launch.mesh import make_local_mesh

    return make_local_mesh(data=shape[0], model=shape[1], device="cpu")


def _shard_leaves(params) -> int:
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.sharding.policy import tree_paths

    return sum(isinstance(t, DTensor) and any(isinstance(p, Shard) for p in t.placements)
               for _, t in tree_paths(params))


def _trajectory(srv, cfg, toks, steps=STEPS):
    """(tokens, exit mask, shipped per hop) per step, greedy from ``toks``."""
    from repro_torch.models import model as M

    caches = srv.executor.shard_caches(
        M.init_caches(cfg, toks.shape[0], CTX, device="cpu"))
    tok, out = toks, []
    for i in range(steps):
        rep, caches = srv.step(tok, i, caches)
        exited = getattr(rep, "exited", getattr(rep, "exited_on_edge", None))
        shipped = getattr(rep, "shipped_per_hop", (getattr(rep, "shipped", 0),))
        out.append((rep.tokens.copy(), np.asarray(exited).copy(), tuple(shipped)))
        tok = rep.tokens[:, None]
    return out


def _report(srv, traj) -> dict:
    ex = srv.executor
    return {"traj": traj, "syncs": ex.host_syncs, "sharded": ex.sharded,
            "use_kernels": ex.use_kernels, "graphs": ex.graphs,
            "shard_leaves": _shard_leaves(ex.params),
            "tier_devices": getattr(srv, "tier_devices", None)}


def _tiers(world):
    from repro_torch.core.multitier import TierSpec

    return [TierSpec("device", 200.0, 1e6), TierSpec("edge", 20.0, 2e7),
            TierSpec("cloud", 1.0, devices=world, ici_bps=1e11)]


def run_k2(shape, compaction, toks, mesh=True) -> dict:
    from repro_torch.serving import PartitionedServer

    cfg = _cfg("gqa")
    srv = PartitionedServer(cfg, _params("gqa"), 2, device="cpu", compaction=compaction,
                            mesh=_mesh(shape) if mesh else None)
    return _report(srv, _trajectory(srv, cfg, toks))


def run_k3(shape, compaction, toks, mesh=True) -> dict:
    from repro_torch.launch.mesh import mesh_devices
    from repro_torch.serving import MultiTierServer

    cfg = _cfg("moe")
    m = _mesh(shape) if mesh else None
    srv = MultiTierServer(cfg, _params("moe"), _tiers(mesh_devices(m)), (1, 3),
                          device="cpu", compaction=compaction, mesh=m)
    return _report(srv, _trajectory(srv, cfg, toks))


def run_engine(shape, prompts, mesh=True) -> dict:
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(_cfg("gqa"), _params("gqa"), context_len=64, device="cpu",
                        mesh=_mesh(shape) if mesh else None)
    toks, _ = eng.decode(eng.start({"tokens": prompts}), steps=5)
    return {"toks": toks, "syncs": eng.host_syncs}


def run_hot_swap(shape, toks) -> dict:
    """Two steps, a move of the first cut only, two more steps: the cloud
    segment's cached function object and its build count."""
    from repro_torch.core.multitier import TierSpec
    from repro_torch.models import model as M
    from repro_torch.serving import MultiTierServer

    cfg = _cfg("moe")
    tiers = [TierSpec("d", 100.0, 1e6), TierSpec("e", 10.0, 1e7), TierSpec("c", 1.0)]
    srv = MultiTierServer(cfg, _params("moe"), tiers, (1, 3), device="cpu",
                          mesh=_mesh(shape))
    ex = srv.executor
    caches = ex.shard_caches(M.init_caches(cfg, toks.shape[0], CTX, device="cpu"))
    tok = toks
    for i in range(2):
        rep, caches = srv.step(tok, i, caches)
        tok = rep.tokens[:, None]
    cloud = {k: fn for k, fn in ex._fn_cache.items() if k[0][:2] == (3, 4)}
    counts = {k: ex.trace_counts[k] for k in cloud}
    srv.install_cuts((2, 3))
    for i in range(2, 4):
        rep, caches = srv.step(tok, i, caches)
        tok = rep.tokens[:, None]
    return {"kept": bool(cloud) and all(ex._fn_cache[k] is fn for k, fn in cloud.items()),
            "rebuilt": {str(k): ex.trace_counts[k] - n for k, n in counts.items()},
            "edge_keys": sorted(str(k) for k in ex._fn_cache if k[0][:2] == (0, 2)),
            "syncs": ex.host_syncs}


def run_flags(shape) -> dict:
    """Kernels asked for resolve off, graphs resolve eager, ``graphs=True``
    raises, and the policy shards at least one param leaf."""
    from repro_torch.serving import PartitionedServer
    from repro_torch.sharding.policy import tree_paths

    cfg, params, mesh = _cfg("gqa"), _params("gqa"), _mesh(shape)
    srv = PartitionedServer(cfg, params, 2, device="cpu", mesh=mesh, use_kernels=True)
    try:
        PartitionedServer(cfg, params, 2, device="cpu", mesh=mesh, graphs=True)
        graphs_raise = False
    except ValueError:
        graphs_raise = True
    return {"use_kernels": srv.executor.use_kernels, "graphs": srv.executor.graphs,
            "graphs_raise": graphs_raise, "shard_leaves": _shard_leaves(srv.executor.params),
            "leaves": sum(1 for _ in tree_paths(srv.executor.params))}


def run_meshes() -> dict:
    """The mesh's defaults, overrides and refusals on this world."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh, mesh_axis_sizes, mesh_devices

    n = dist.get_world_size()
    out = {"default": mesh_axis_sizes(make_local_mesh(device="cpu"))}
    if n == 4:
        m = make_local_mesh(data=2, model=2, device="cpu")
        out["override"] = (mesh_axis_sizes(m), mesh_devices(m))
        out["partial"] = mesh_axis_sizes(make_local_mesh(model=2, device="cpu"))
    try:
        make_local_mesh(data=n, model=2, device="cpu")
        out["over"] = None
    except ValueError as e:
        out["over"] = str(e)
    return out


def run_host_gather() -> dict:
    """The host-staged ``all_gather_into_tensor`` against DTensor's own
    gather of the same shards (called directly: registering it would
    replace this rank's CPU collective)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import mesh as mesh_mod

    m = _mesh((1, dist.get_world_size()))
    x = torch.arange(12.0).reshape(3, 4) + 100 * dist.get_rank()
    want = DTensor.from_local(x, m, [Replicate(), Shard(0)]).redistribute(
        m, [Replicate(), Replicate()]).to_local()
    group = m.get_group(1)
    got = mesh_mod._all_gather(x, dist.get_world_size(), group.group_name)
    return {"equal": bool(torch.equal(got, want)), "input_kept": bool(
        torch.equal(x, torch.arange(12.0).reshape(3, 4) + 100 * dist.get_rank()))}


# ------------------------------------------------------------- the tests
@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these shapes are small, and the test run's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """The reference's fixtures' params as (fp32 numpy, dtype name) leaves."""
    import jax

    from repro.configs import get_smoke_config as j_smoke
    from repro.models import model as JM

    out = {}
    for name, (arch, seed) in FIXTURES.items():
        cfg = dataclasses.replace(j_smoke(arch), **DEEP)
        tree = JM.init_params(jax.random.PRNGKey(seed), cfg)

        def conv(t):
            if isinstance(t, dict):
                return {k: conv(v) for k, v in t.items()}
            a = np.asarray(t)
            return (np.asarray(a, np.float32),
                    "bfloat16" if a.dtype.name == "bfloat16" else "float32")

        out[name] = conv(tree)
    return out


@pytest.fixture(scope="module")
def inputs():
    import jax

    cfg = _cfg("gqa")
    return {
        "toks": np.asarray(jax.random.randint(jax.random.PRNGKey(2), (BATCH, 1), 0,
                                              cfg.vocab_size), np.int32),
        "moe_toks": np.asarray(jax.random.randint(jax.random.PRNGKey(2), (BATCH, 1), 0,
                                                  _cfg("moe").vocab_size), np.int32),
        "prompts": np.asarray(jax.random.randint(jax.random.PRNGKey(3), (BATCH, 6), 0,
                                                 cfg.vocab_size), np.int32),
    }


@pytest.fixture(scope="module")
def local(weights):
    """The unsharded runs, in this process."""
    _load(weights)
    cache = {}

    def get(fn, *args):
        key = (fn.__name__, *(a if not isinstance(a, np.ndarray) else a.tobytes()
                              for a in args))
        if key not in cache:
            cache[key] = fn(*args, mesh=False)
        return cache[key]

    return get


def _pool(world, weights):
    pool = RankPool(world, device="cpu", threads=1, timeout_s=240.0)
    pool.run(_load, weights)
    return pool


@pytest.fixture(scope="module")
def pool2(weights):
    pool = _pool(2, weights)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def pool4(weights):
    pool = _pool(4, weights)
    yield pool
    pool.close()


@pytest.fixture
def pools(pool2, pool4):
    return {2: pool2, 4: pool4}


def _same_trajectory(ref, got, what):
    assert len(ref) == len(got)
    for step, ((rt, rx, rs), (gt, gx, gs)) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(gt, rt, err_msg=f"{what}: tokens @ step {step}")
        np.testing.assert_array_equal(gx, rx, err_msg=f"{what}: exits @ step {step}")
        assert gs == rs, f"{what}: shipped @ step {step}"


def _check_sharded(results, ref, shape, what):
    width = SHARD_WIDTHS[shape]
    for rank, got in enumerate(results):
        _same_trajectory(ref["traj"], got["traj"], f"{what}, rank {rank}")
        assert got["syncs"] == ref["syncs"] == STEPS, (rank, got["syncs"])
        assert got["sharded"] and got["use_kernels"] is False and got["graphs"] is False
        assert got["shard_leaves"] > 0
    assert ref["sharded"] is False
    if results[0]["tier_devices"] is not None:
        assert results[0]["tier_devices"] == (1, width)


class TestShardedEquivalence:
    """A sharded run gives the unsharded trajectory, step by step."""

    @pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
    @pytest.mark.parametrize("compaction", ["bucketed", "off"])
    def test_k2_partitioned_gqa(self, pools, local, inputs, shape, compaction):
        ref = local(run_k2, (1, 1), compaction, inputs["toks"])
        got = pools[SHARD_WIDTHS[shape]].run(run_k2, shape, compaction, inputs["toks"])
        _check_sharded(got, ref, shape, f"K=2 {shape} {compaction}")

    @pytest.mark.parametrize("shape,compaction", [((1, 2), "bucketed"), ((1, 2), "off"),
                                                  ((2, 2), "bucketed")])
    def test_k3_multitier_moe(self, pools, local, inputs, shape, compaction):
        ref = local(run_k3, (1, 1), compaction, inputs["moe_toks"])
        got = pools[SHARD_WIDTHS[shape]].run(run_k3, shape, compaction, inputs["moe_toks"])
        _check_sharded(got, ref, shape, f"K=3 MoE {shape} {compaction}")

    @pytest.mark.parametrize("shape", [(2, 2)])
    def test_k1_engine_matches_unsharded(self, pools, local, inputs, shape):
        ref = local(run_engine, (1, 1), inputs["prompts"])
        for rank, got in enumerate(pools[SHARD_WIDTHS[shape]].run(
                run_engine, shape, inputs["prompts"])):
            np.testing.assert_array_equal(got["toks"], ref["toks"], err_msg=f"rank {rank}")
            assert got["syncs"] == ref["syncs"] == 5

    def test_hot_swap_keeps_sharded_segment_fns(self, pool2, inputs):
        for rank, got in enumerate(pool2.run(run_hot_swap, (1, 2), inputs["moe_toks"])):
            assert got["kept"], rank
            assert all(n == 0 for n in got["rebuilt"].values()), got["rebuilt"]
            assert got["edge_keys"], "the moved cut built no edge segment"
            assert got["syncs"] == 4


class TestShardedExecutor:
    def test_kernels_and_graphs_resolve_off(self, pool2):
        for got in pool2.run(run_flags, (1, 2)):
            assert got["use_kernels"] is False and got["graphs"] is False
            assert got["graphs_raise"]
            assert 0 < got["shard_leaves"] <= got["leaves"]

    def test_one_device_mesh_is_unsharded(self, weights):
        class OneDevice:
            shape = {"data": 1, "model": 1}

        from repro_torch.serving import PartitionedServer

        _load(weights)
        srv = PartitionedServer(_cfg("gqa"), _params("gqa"), 2, device="cpu",
                                mesh=OneDevice())
        assert not srv.executor.sharded and srv.tier_devices == (1, 1)
        assert srv.executor.shard_caches({"x": 1}) == {"x": 1}


class TestMeshConstruction:
    def test_host_staged_all_gather(self, pool2):
        for got in pool2.run(run_host_gather):
            assert got == {"equal": True, "input_kept": True}

    def test_mesh_defaults_overrides_and_refusal(self, pool2, pool4):
        for got in pool2.run(run_meshes):
            assert got["default"] == {"data": 1, "model": 2}
            assert "only" in got["over"]
        for got in pool4.run(run_meshes):
            assert got["default"] == {"data": 1, "model": 4}
            assert got["override"] == ({"data": 2, "model": 2}, 4)
            assert got["partial"] == {"data": 2, "model": 2}
            assert "only" in got["over"]
