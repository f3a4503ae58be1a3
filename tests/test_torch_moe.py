"""Routed experts in the port (``repro_torch.models.moe``, the
``BlockKind("gqa", "moe")`` trunk of ``qwen3_moe_30b_a3b``) against the
reference package on the CPU, on weights carried by ``repro_torch.bridge``.

Tolerances, each stated at its check:

  * ``router_topk`` on the same logits: indices exact (ties to the lower
    expert index, as ``jax.lax.top_k``), weights and aux 1e-6 relative;
  * ``moe_apply`` in fp32 compute: outputs and aux within 1e-5 (rtol and
    atol); the keep mask exact (a decode-like group where the capacity is
    one slot per expert and choices drop);
  * ``moe_apply`` in bf16 compute: the routing first (top-k indices and
    keep mask), where a token may differ only at a near-tie (its top-k
    margin within one bf16 ulp), counted; then the outputs of every group
    whose routing agrees within 2^-5 (rtol and atol: four bf16 ulps at
    unit scale, the port's bf16 model tolerance);
  * the smoke model in fp32: ``forward_train``'s losses and aux 1e-5
    relative, every gradient leaf within 1e-4 of its largest magnitude,
    prefill and decode logits 1e-4; a K=2 ``PartitionedServer`` step by
    step against the reference's: tokens, exits and bytes exact, logits
    1e-4.

Graphed == eager and one host sync per step need a card: ``chip_smoke.py``
holds them on the full-width model.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMo
from repro.serving import PartitionedServer as JPartitionedServer
from repro.training import optimizer as JO
from repro.training import train_loop as JT
from repro_torch import bridge
from repro_torch.configs import ModelConfig
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMo
from repro_torch.serving import PartitionedServer
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TT
from repro_torch.training.tree import tree_items, tree_leaves, tree_map

FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2.0 ** -5, atol=2.0 ** -5)
ARCH = "qwen3_moe_30b_a3b"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these shapes are small, and the test run's
    workers share the cores (this file takes gradients)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    jcfg = dataclasses.replace(j_smoke(ARCH), **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _moe_weights(jcfg, seed=0):
    jp = JMo.moe_init(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ------------------------------------------------------------ router_topk
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_topk_matches_reference(dtype):
    """Random logits (2 groups x 16 tokens x 128 experts; in bf16 many
    exact ties): indices exact, weights and aux 1e-6 relative."""
    r = np.random.default_rng(0)
    logits = jnp.asarray(r.standard_normal((2, 16, 128)), jnp.dtype(dtype))
    jw, ji, ja = JMo.router_topk(logits, 8)
    tl = _t(_f32(logits)).to(getattr(torch, dtype))
    tw, ti, ta = TMo.router_topk(tl, 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.float().numpy(), _f32(jw), rtol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    assert tw.dtype == tl.dtype


def test_router_topk_breaks_exact_ties_toward_the_lower_index():
    """A row whose four largest logits are equal, at experts 1, 2, 4 and 6
    (a fifth equal one at 9 loses): the lower indices first, in order, as
    ``jax.lax.top_k`` returns them."""
    row = np.full(16, -1.0, np.float32)
    row[[1, 2, 4, 6, 9]] = 3.0
    logits = np.stack([row, row[::-1].copy()])[None]  # (1, 2, 16)
    _, ji, _ = JMo.router_topk(jnp.asarray(logits, jnp.bfloat16), 4)
    _, ti, _ = TMo.router_topk(_t(logits).to(torch.bfloat16), 4)
    assert ti[0, 0].tolist() == [1, 2, 4, 6] == np.asarray(ji)[0, 0].tolist()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ------------------------------------------------------------ moe_apply
def _ref_routing(jp, x, jcfg, gsz):
    """The reference's own routing steps of ``moe_apply`` (its router
    logits, top-k indices and keep mask; ``src/repro/models/moe.py``
    lines 119-138), which ``moe_apply`` does not return."""
    b, s, d = x.shape
    e, k = jcfg.num_experts, jcfg.experts_per_token
    t = b * s
    gsz = min(gsz, t)
    tokens = jnp.pad(x.reshape(t, d), ((0, (-t) % gsz), (0, 0)))
    xg = tokens.reshape(-1, gsz, d)
    logits = JL.dense(jp["router"], xg, x.dtype)
    _, idx, _ = JMo.router_topk(logits, k)
    cap = max(int(np.ceil(gsz * k * jcfg.capacity_factor / e)), 1)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.int32)
    flat = onehot.reshape(xg.shape[0], gsz * k, e)
    pos = ((jnp.cumsum(flat, axis=1) - 1) * flat).sum(-1).reshape(idx.shape)
    return _f32(logits), np.asarray(idx), np.asarray(pos < cap), cap


def _port_routing(tp, x, tcfg, gsz):
    b, s, d = x.shape
    t = b * s
    gsz = min(gsz, t)
    xg = torch.nn.functional.pad(x.reshape(t, d), (0, 0, 0, (-t) % gsz)).reshape(-1, gsz, d)
    _, idx, _ = TMo.router_topk(TL.dense(tp["router"], xg, x.dtype), tcfg.experts_per_token)
    cap = max(math.ceil(gsz * tcfg.experts_per_token * tcfg.capacity_factor
                        / tcfg.num_experts), 1)
    _, keep = TMo.expert_slots(idx, tcfg.num_experts, cap)
    return idx.numpy(), keep.numpy()


#: (label, config overrides, x shape, group size).  "ragged": 21 tokens in
#: groups of 4 (the last padded); "decode": 6 rows, 32 experts, top-4, one
#: slot per expert (cap = ceil(6 * 4 * 1.25 / 32) = 1: choices drop);
#: "shared": one shared expert beside the routed ones.
CASES = [
    ("ragged", {}, (3, 7), 4),
    ("decode", dict(num_experts=32, experts_per_token=4), (6, 1), 256),
    ("shared", dict(num_shared_experts=1), (2, 9), 256),
]


@pytest.mark.parametrize("mode", ["einsum", "onehot_small", "auto"])
@pytest.mark.parametrize("label,over,shape,gsz", CASES, ids=[c[0] for c in CASES])
def test_moe_apply_fp32_matches_reference(mode, label, over, shape, gsz):
    jcfg, tcfg = _cfgs(dtype="float32", **over)
    jp, tp = _moe_weights(jcfg)
    x = np.random.default_rng(1).standard_normal((*shape, jcfg.d_model)).astype(np.float32)
    jy, ja = JMo.moe_apply(jp, jnp.asarray(x), jcfg, group_size=gsz, dispatch=mode)
    ty, ta = TMo.moe_apply(tp, _t(x), tcfg, group_size=gsz, dispatch=mode)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FP32)
    np.testing.assert_allclose(float(ta), float(ja), **FP32)
    _, jidx, jkeep, cap = _ref_routing(jp, jnp.asarray(x), jcfg, gsz)
    tidx, tkeep = _port_routing(tp, _t(x), tcfg, gsz)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tkeep, jkeep)
    if label == "decode":
        assert cap == 1 and int((~tkeep).sum()) > 0  # choices were dropped
    if label == "ragged":
        assert (shape[0] * shape[1]) % gsz != 0


@pytest.mark.parametrize("mode", ["einsum", "onehot_small"])
@pytest.mark.parametrize("label,over,shape,gsz", CASES, ids=[c[0] for c in CASES])
def test_moe_apply_bf16_routing_then_outputs(mode, label, over, shape, gsz):
    """bf16 compute: routing compared first; a token whose top-k differs
    is allowed only where its reference top-k margin is within one bf16
    ulp of a tie (counted); outputs of groups whose routing agrees within
    2^-5."""
    jcfg, tcfg = _cfgs(dtype="bfloat16", **over)
    jp, tp = _moe_weights(jcfg, seed=3)
    x = np.random.default_rng(2).standard_normal((*shape, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = _t(x).to(torch.bfloat16)
    jlog, jidx, jkeep, _ = _ref_routing(jp, jx, jcfg, gsz)
    tidx, tkeep = _port_routing(tp, tx, tcfg, gsz)
    k = jcfg.experts_per_token
    differ = (np.sort(tidx, -1) != np.sort(jidx, -1)).any(-1)  # (G, T)
    top = -np.sort(-jlog, -1)
    margin = top[..., k - 1] - top[..., k]
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(top[..., k - 1]), 2.0 ** -126))) - 7)
    assert (margin[differ] <= ulp[differ]).all(), "a routing flip away from a tie"
    flips = int(differ.sum())
    # A group is compared only where its routing agrees on every token.
    agree = ~(differ.any(-1) | (tkeep != jkeep).any((-1, -2)))
    jy, _ = JMo.moe_apply(jp, jx, jcfg, group_size=gsz, dispatch=mode)
    ty, _ = TMo.moe_apply(tp, tx, tcfg, group_size=gsz, dispatch=mode)
    t = shape[0] * shape[1]
    gsz_ = min(gsz, t)
    g_of_token = np.arange(t) // gsz_
    rows = agree[g_of_token]
    np.testing.assert_allclose(ty.float().numpy().reshape(t, -1)[rows],
                               _f32(jy).reshape(t, -1)[rows], **BF16)
    assert rows.sum() >= t - flips * gsz_, (flips, rows.sum())


# ------------------------------------------------------------ the smoke model
@pytest.fixture(scope="module")
def model_weights():
    jcfg, _ = _cfgs(dtype="float32", num_layers=4, branch_layers=(1, 3))
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _key(path) -> str:
    return "##".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def test_init_params_tree_is_the_reference_s(model_weights):
    """The port's own init of the MoE trunk: the reference's tree, leaf
    shapes and dtypes (fp32; bf16 under ``param_dtype``)."""
    jp, _ = model_weights
    for pd in ("float32", "bfloat16"):
        jcfg, tcfg = _cfgs(dtype="float32", num_layers=4, branch_layers=(1, 3),
                           param_dtype=pd)
        tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
        want = {_key(p): (a.shape, pd) for p, a in jax.tree_util.tree_leaves_with_path(jp)}
        got = {"##".join(map(str, p)): (tuple(t.shape), str(t.dtype).split(".")[-1])
               for p, t in tree_items(tp)}
        assert got == want
    assert tp["blocks"]["moe"]["w_gate"].shape == (4, 4, tcfg.d_model, tcfg.moe_d_ff)


def test_forward_train_losses_aux_and_grads(model_weights):
    jp, tp = model_weights
    jcfg, tcfg = _cfgs(dtype="float32", num_layers=4, branch_layers=(1, 3))
    r = np.random.default_rng(5)
    toks = r.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": _t(toks).long(), "labels": _t(toks).long()}

    def loss_fn(p, b):
        out = JM.forward_train(p, b, jcfg)
        return out["loss"], out

    (_, jo), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp, jb)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
    it = iter(leaves)
    to = TM.forward_train(tree_map(lambda _: next(it), tp), tb, tcfg)
    grads = torch.autograd.grad(to["loss"], leaves)
    for name in ("loss", "main_loss", "aux_loss"):  # 1e-5 relative
        np.testing.assert_allclose(float(to[name].detach()), float(jo[name]), rtol=1e-5)
    assert float(jo["aux_loss"]) > 0.0  # four MoE layers' Switch aux
    assert to["branch_losses"].keys() == jo["branch_losses"].keys() == {"branch_1",
                                                                         "branch_3"}
    for k, v in jo["branch_losses"].items():
        np.testing.assert_allclose(float(to["branch_losses"][k].detach()), float(v),
                                   rtol=1e-5)
    want = {_key(p): np.asarray(a) for p, a in jax.tree_util.tree_leaves_with_path(jg)}
    got = {"##".join(map(str, p)): g.numpy()
           for (p, _), g in zip(tree_items(tp), grads)}
    assert got.keys() == want.keys()
    for k, w in want.items():  # 1e-4 of each leaf's largest magnitude
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(got[k] - w).max()) <= 1e-4 * scale, k
    assert float(np.abs(want["blocks##moe##router"]).max()) > 0


@pytest.mark.parametrize("mode", ["einsum", "onehot_small"])
def test_train_step_threads_moe_dispatch(model_weights, mode):
    """One AdamW step of ``make_train_step(moe_dispatch=...)`` in both
    packages: the loss and aux 1e-5 relative, the updated router within
    1e-6 + 1e-5 relative."""
    jp, tp = model_weights
    jcfg, tcfg = _cfgs(dtype="float32", num_layers=4, branch_layers=(1, 3))
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jopt, topt = JO.make_optimizer("adamw", lr=1e-3), TO.make_optimizer("adamw", lr=1e-3)
    jstate, jm = jax.jit(JT.make_train_step(jcfg, jopt, moe_dispatch=mode, accum=1))(
        JT.init_train_state(jp, jopt), {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(toks)})
    tstate, tm = TT.make_train_step(tcfg, topt, moe_dispatch=mode, accum=1)(
        TT.init_train_state(tp, topt), {"tokens": _t(toks).long(), "labels": _t(toks).long()})
    for name in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-5)
    np.testing.assert_allclose(
        tstate["params"]["blocks"]["moe"]["router"].numpy(),
        np.asarray(jstate["params"]["blocks"]["moe"]["router"]), rtol=1e-5, atol=1e-6)


def test_prefill_then_decode(model_weights):
    jp, tp = model_weights
    jcfg, tcfg = _cfgs(dtype="float32", num_layers=4, branch_layers=(1, 3))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (4, 10)).astype(np.int32)
    jl, jc = jax.jit(JM.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks)}, jcfg, JM.init_caches(jcfg, 4, 16))
    tpc = TM.compute_params(tp, torch.float32)
    tl, tc = TM.prefill(tpc, _t(toks).long(), tcfg, TM.init_caches(tcfg, 4, 16, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    tok = np.argmax(np.asarray(jl[:, 0]), -1)[:, None].astype(np.int32)
    jo = JM.decode_step(jp, jnp.asarray(tok), jnp.asarray(10), jc, jcfg, use_kernels=False)
    to = TM.decode_step(tpc, _t(tok).long(), 10, tc, tcfg)
    np.testing.assert_allclose(to["logits"].numpy(), np.asarray(jo["logits"]),
                               rtol=1e-4, atol=1e-4)
    for layer in (1, 3):
        np.testing.assert_allclose(to["branch_entropy"][layer].numpy(),
                                   np.asarray(jo["branch_entropy"][layer]), atol=1e-5)
    assert int(to["caches"]["length"]) == 11


def test_served_k2_run_equals_the_reference(model_weights):
    """A K=2 ``PartitionedServer`` at split 2 (edge branch 1), the
    threshold at the first step's median entropy, so the cloud runs
    compacted buckets (MoE groups of the survivors only, as in the
    reference): 6 steps on identical batches, tokens, exits and bytes
    exact in fp32, logits 1e-4."""
    jp, tp = model_weights
    jcfg, tcfg = _cfgs(dtype="float32", num_layers=4, branch_layers=(1, 3))
    toks = np.array(jax.random.randint(jax.random.PRNGKey(2), (8, 1), 0, jcfg.vocab_size))
    probe = JPartitionedServer(jcfg, jp, 2, use_kernels=False)
    rep, _ = probe.step(jnp.asarray(toks), 0, JM.init_caches(jcfg, 8, 32))
    thr = float(np.median(rep.tier_result.branch_entropy[1]))
    jcfg, tcfg = _cfgs(dtype="float32", num_layers=4, branch_layers=(1, 3),
                       exit_threshold=thr)
    # Bucket hints from the last step only, so that the cloud's groups
    # follow the survivors (and an overflow re-runs at full width).
    js = JPartitionedServer(jcfg, jp, 2, use_kernels=False, hint_window=1)
    ts = PartitionedServer(tcfg, tp, 2, device="cpu", hint_window=1)
    jc, tc = JM.init_caches(jcfg, 8, 32), TM.init_caches(tcfg, 8, 32, device="cpu")
    jt, tt = jnp.asarray(toks), toks
    exits, buckets = 0, set()
    for i in range(6):
        jr, jc = js.step(jt, i, jc)
        tr, tc = ts.step(tt, i, tc)
        np.testing.assert_array_equal(tr.tokens, np.asarray(jr.tokens))
        np.testing.assert_array_equal(tr.exited_on_edge, np.asarray(jr.exited_on_edge))
        assert (tr.shipped, tr.bytes_shipped) == (jr.shipped, jr.bytes_shipped)
        live = ~tr.exited_on_edge
        np.testing.assert_allclose(tr.tier_result.last_logits.numpy()[live],
                                   np.asarray(jr.tier_result.last_logits)[live],
                                   rtol=1e-4, atol=1e-4)
        exits += int(tr.exited_on_edge.sum())
        assert [c.bucket for c in tr.tier_result.compaction] == \
            [c.bucket for c in jr.tier_result.compaction]
        buckets |= {c.bucket for c in tr.tier_result.compaction}
        jt, tt = jr.tier_result.tokens_dev[:, None], tr.tier_result.tokens_dev[:, None]
    assert 0 < exits < 6 * 8
    assert min(buckets) < 8  # compacted cloud groups
