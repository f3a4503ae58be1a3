"""The port's sharding policy and a sharded tier's price against the
reference package.

* ``repro_torch.sharding.policy`` against ``repro.sharding.policy`` path by
  path, on the duck-typed meshes of ``tests/test_sharding_policy.py``
  (data 16 x model 16, model 8, and pod 2 x data 16 x model 16): every
  param and cache leaf of all ten configs at full published size (the
  port's trees on the ``meta`` device, the reference's from
  ``jax.eval_shape``), the AdamW and Adafactor optimizer-state specs, and
  the data and logits specs at batch 1 and 8, including the kv = 10 and
  vocab = 51,865 fallbacks.  A reference ``PartitionSpec`` is read as a
  tuple padded with None to its tensor's rank (the port's specs have one
  entry per dim); the reference's optimizer-state specs are read with
  ``NamedSharding`` swapped for its spec, since it needs a real mesh.
* ``placements``: a spec as DTensor placements.
* Pricing: ``profile_decode_layers(devices=4, mode="analyze")`` against the
  reference's on the suite's fixture (the ``phi3_mini_3_8b`` smoke config
  at 4 layers, branches 1 and 3, fp32), and exactly against the port's own
  ``devices=1`` costs over the shard width plus the collective term; and
  ``PartitionedServer(tier_devices=(1, 4), ici_bps=...).est_latency_s``
  against the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sharding.policy as jpol_mod
from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.core import LayerCost as JLayerCost
from repro.core import build_cost_profile as j_build_cost_profile
from repro.core import profiler as JP
from repro.models import model as JM
from repro.serving import PartitionedServer as JPartitionedServer
from repro.sharding.policy import ShardingPolicy as JPolicy
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, ModelConfig, get_config
from repro_torch.core import LayerCost, build_cost_profile
from repro_torch.core import profiler as TP
from repro_torch.models import model as TM
from repro_torch.serving import PartitionedServer
from repro_torch.sharding.policy import (
    ShardingPolicy,
    cache_shapes,
    param_shapes,
    placements,
    tree_paths,
)

MESHES = {"d16m16": dict(data=16, model=16), "m8": dict(model=8),
          "p2d16m16": dict(pod=2, data=16, model=16)}


class FakeMesh:
    """Duck-typed mesh: the policy reads only ``.shape`` (a dict)."""

    def __init__(self, **axes):
        self.shape = dict(axes)


def _policies(arch, mesh):
    axes = MESHES[mesh]
    batch = tuple(a for a in ("pod", "data") if a in axes)
    return (JPolicy(mesh=FakeMesh(**axes), cfg=j_config(arch), batch_axes=batch),
            ShardingPolicy(mesh=FakeMesh(**axes), cfg=get_config(arch), batch_axes=batch))


def _read(spec, rank):
    """A reference spec as a tuple padded with None to ``rank``."""
    t = tuple(spec)
    assert len(t) <= rank, (t, rank)
    return t + (None,) * (rank - len(t))


def _jpaths(tree):
    return {"/".join(jpol_mod._key_str(k) for k in kp): leaf
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


_SHAPES: dict = {}


def _shapes(arch):
    """(reference param shapes, port param shapes, reference cache shapes,
    port cache shapes) at full size; caches at batch 16 x 256."""
    if arch not in _SHAPES:
        jcfg, tcfg = j_config(arch), get_config(arch)
        _SHAPES[arch] = (
            _jpaths(jax.eval_shape(lambda k: JM.init_params(k, jcfg), jax.random.PRNGKey(0))),
            dict(tree_paths(param_shapes(tcfg))),
            _jpaths(jax.eval_shape(lambda: JM.init_caches(jcfg, 16, 256))),
            dict(tree_paths(cache_shapes(tcfg, 16, 256))),
        )
    return _SHAPES[arch]


def _same_leaves(jleaves, tleaves):
    assert jleaves.keys() == tleaves.keys()
    for path, t in tleaves.items():
        assert t.is_meta, f"{path} holds memory"
        assert tuple(t.shape) == tuple(jleaves[path].shape), path


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
class TestSpecsAgainstReference:
    def test_param_specs(self, arch, mesh):
        jleaves, tleaves, _, _ = _shapes(arch)
        _same_leaves(jleaves, tleaves)
        jpol, tpol = _policies(arch, mesh)
        for path, t in tleaves.items():
            shape = tuple(t.shape)
            assert tpol.param_spec(path, shape) == _read(
                jpol.param_spec(path, shape), len(shape)), path

    def test_cache_specs(self, arch, mesh):
        _, _, jleaves, tleaves = _shapes(arch)
        _same_leaves(jleaves, tleaves)
        jpol, tpol = _policies(arch, mesh)
        for path, t in tleaves.items():
            shape = tuple(t.shape)
            assert tpol.cache_spec(path, shape) == _read(
                jpol.cache_spec(path, shape), len(shape)), path
            # Batch 1 never shards its batch.
            one = (shape[0], 1, *shape[2:]) if len(shape) > 2 else shape
            assert tpol.cache_spec(path, one) == _read(jpol.cache_spec(path, one), len(one))


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_opt_state_specs(arch, opt, monkeypatch):
    monkeypatch.setattr(jpol_mod, "NamedSharding", lambda mesh, spec: spec)
    jleaves, tleaves, _, _ = _shapes(arch)
    jpol, tpol = _policies(arch, "d16m16")
    # Both trees flat, keyed by path (the rules read only the path).
    got = tpol.opt_state_shardings(tleaves, opt)
    want = jpol.opt_state_shardings(jleaves, opt)
    if opt == "adamw":
        for key in ("m", "v"):
            for path, t in tleaves.items():
                assert got[key][path] == _read(want[key][path], t.dim()), (key, path)
        return
    for path, t in tleaves.items():
        g, w = got[path], want[path]
        assert g.keys() == w.keys(), path
        for k in g:
            assert g[k] == _read(w[k], len(g[k])), (path, k)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["qwen3_8b", "phi3_medium_14b", "whisper_medium"])
def test_data_and_logits_specs(arch, mesh):
    jpol, tpol = _policies(arch, mesh)
    for batch in (1, 8, 16, 256):
        for shape in ((batch, 4096), (batch,)):
            assert tpol.data_spec(shape) == _read(jpol.data_spec(shape), len(shape))
        assert tpol.batch_spec_axes(batch) == (
            None if jpol.batch_spec_axes(batch) is None
            else tuple(jax.sharding.PartitionSpec(jpol.batch_spec_axes(batch)))[0])
    assert tpol.logits_spec() == _read(jpol.logits_spec(), 3)


def test_known_fallbacks():
    """Phi-3-medium's 10 KV heads and Whisper's 51,865 vocab replicate over
    16 (the KV cache takes head_dim), as the reference's rules do."""
    _, phi = _policies("phi3_medium_14b", "d16m16")
    assert phi.cache_spec("blocks/self/k", (40, 16, 256, 10, 128)) == (
        None, "data", None, None, "model")
    assert phi.cache_spec("blocks/self/k", (40, 1, 256, 10, 128))[1] is None
    _, whisper = _policies("whisper_medium", "d16m16")
    assert whisper.param_spec("embed", (51865, 1024)) == (None, None)
    assert whisper.logits_spec() == ("data", None, None)
    _, qwen = _policies("qwen3_8b", "m8")
    assert qwen.cache_spec("blocks/self/k", (36, 8, 4096, 8, 128)) == (
        None, None, None, "model", None)
    assert qwen.data_spec((8, 1)) == (None, None)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeMesh(pod=2, data=16, model=16)
    assert placements((None, "model"), mesh) == [Replicate(), Replicate(), Shard(1)]
    assert placements((("pod", "data"), None, "model"), mesh) == [Shard(0), Shard(0), Shard(2)]
    assert placements((None, None), mesh) == [Replicate()] * 3


# ------------------------------------------------------------------ price
def _fixture_cfgs():
    jcfg = dataclasses.replace(j_smoke("phi3_mini_3_8b"), num_layers=4,
                               branch_layers=(1, 3), dtype="float32")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def fixture_weights():
    jcfg, _ = _fixture_cfgs()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_sharded_analyze_profile_against_reference(fixture_weights):
    jp, tp = fixture_weights
    jcfg, tcfg = _fixture_cfgs()
    hw = TP.H100_SXM
    jhw = JP.HardwareSpec(hw.name, hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.hbm_bytes)
    b, c, d = 2, 16, 4
    one = TP.profile_decode_layers(tcfg, tp, b, c, mode="analyze")
    got = TP.profile_decode_layers(tcfg, tp, b, c, mode="analyze", devices=d,
                                   use_kernels=True)  # resolves off: sharded
    xla = JP.profile_decode_layers(jcfg, jp, b, c, use_kernels=False, mode="analyze",
                                   hardware=jhw, devices=d)
    assert len(got) == len(xla) == tcfg.num_layers
    for o, t, x in zip(one, got, xla):
        # Exactly the devices=1 costs over the shard width plus the collective.
        assert (t.flops, t.bytes_accessed, t.output_bytes) == (
            o.flops, o.bytes_accessed, o.output_bytes)
        assert t.time_s == pytest.approx(
            o.time_s / d + hw.collective_time(o.output_bytes, d), rel=1e-12)
        # The counters' tolerance (test_torch_core.py), against XLA's.
        assert t.flops == pytest.approx(x.flops, rel=0.01)
        assert t.bytes_accessed == pytest.approx(x.bytes_accessed, rel=0.15)
        assert t.output_bytes == x.output_bytes
        assert t.time_s == pytest.approx(x.time_s, rel=0.15)
        assert hw.collective_time(t.output_bytes, d) == pytest.approx(
            jhw.collective_time(x.output_bytes, d), rel=1e-12)


def test_sharded_tier_estimate_against_reference(fixture_weights):
    """est_latency_s of a K=2 server whose cloud is priced as 4 cards over
    NVLink, step by step against the reference's, and apart from the
    one-card estimate."""
    jp, tp = fixture_weights
    jcfg, tcfg = _fixture_cfgs()
    batch, split, ici = 4, 2, TP.H100_SXM.link_bw * 8

    def costs(cls):
        return [cls(f"layer{i}", 0.0, 0.0, batch * tcfg.d_model * 4.0, 1e-3 * (1 + i))
                for i in range(1, tcfg.num_layers + 1)]

    jprof = j_build_cost_profile(costs(JLayerCost), jcfg.branch_layers, [0.4, 0.3],
                                 "4g", 25.0, 32 * 1024.0)
    tprof = build_cost_profile(costs(LayerCost), tcfg.branch_layers, [0.4, 0.3],
                               "4g", 25.0, 32 * 1024.0)
    js = JPartitionedServer(jcfg, jp, split, cost_profile=jprof, use_kernels=False,
                            tier_devices=(1, 4), ici_bps=ici)
    ts = PartitionedServer(tcfg, tp, split, cost_profile=tprof, device="cpu",
                           tier_devices=(1, 4), ici_bps=ici)
    flat = PartitionedServer(tcfg, tp, split, cost_profile=tprof, device="cpu")
    assert ts.tier_devices == (1, 4) and flat.tier_devices == (1, 1)
    assert [s.devices for s in ts.executor.segments] == [1, 4]
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (batch, 1)).astype(np.int32)
    jc = JM.init_caches(jcfg, batch, 16)
    tc = TM.init_caches(tcfg, batch, 16, device="cpu")
    fc = TM.init_caches(tcfg, batch, 16, device="cpu")
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    for i in range(2):
        jr, jc = js.step(jt, i, jc)
        tr, tc = ts.step(tt, i, tc)
        fr, fc = flat.step(tt, i, fc)
        np.testing.assert_array_equal(tr.tokens, jr.tokens)
        assert np.isfinite(tr.est_latency_s)
        assert tr.est_latency_s == pytest.approx(jr.est_latency_s, rel=1e-12)
        assert tr.est_latency_s != pytest.approx(fr.est_latency_s, rel=1e-6)
        jt, tt = jnp.asarray(jr.tokens[:, None]), torch.from_numpy(tr.tokens[:, None])
