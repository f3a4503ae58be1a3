"""The port's training path (``repro_torch.models.model.forward_train``,
``models.attention.FlashAttention``, ``repro_torch.training``,
``repro_torch.data.pipeline``, ``bridge.train_state_from_jax`` and
``examples.train_branchy``) against the reference package on the CPU.

Weights come from the reference's ``init_params(PRNGKey(0))`` through
``repro_torch.bridge``; the JAX side is jitted.  Tolerances, each stated
at its check:

  * ``forward_train`` at fp32 compute and fp32 params: the loss, the main
    and each branch loss to 1e-5 relative; every gradient leaf to 1e-4 of
    its largest magnitude (the two frameworks sum the same fp32 products in
    other orders);
  * the attention backward: 1e-5 of each gradient's largest magnitude,
    against plain autograd of ``prefill_attention`` and against the
    reference's ``_flash_vjp``;
  * one optimizer update: elementwise 1e-6 relative (atol 1e-9 for the
    entries that round to zero);
  * ``make_batch`` and checkpoints in both directions: bitwise.
"""

import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.data import pipeline as JD
from repro.models import attention as JAttn
from repro.models import model as JM
from repro.training import checkpoint as JC
from repro.training import optimizer as JO
from repro.training import train_loop as JT
from repro_torch import bridge
from repro_torch.configs import ModelConfig
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.data import pipeline as TD
from repro_torch.examples import train_branchy
from repro_torch.models import attention as TAttn
from repro_torch.models import model as TM
from repro_torch.models.transformer import layer_slice, unstack
from repro_torch.training import checkpoint as TC
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TT
from repro_torch.training.tree import tree_items, tree_leaves, tree_map

ARCHS = ["phi3_mini_3_8b", "olmo_1b", "mamba2_130m", "zamba2_1_2b", "qwen3_8b"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small shapes: the test run's workers
    share the cores, and oversubscribed intra-op pools slowed this file's
    torch-only tests over 100x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               param_dtype="float32", **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _key(path) -> str:
    return "##".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _jax_flat(tree) -> dict:
    return {_key(p): np.asarray(a) for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _torch_flat(tree) -> dict:
    return {"##".join(map(str, p)): t.detach().float().numpy() for p, t in tree_items(tree)}


def _batch(jcfg, b=4, s=32, seed=0):
    nb = JD.make_batch(jcfg, b, s, seed)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _assert_tree_close(got: dict, want: dict, frac: float):
    """Every leaf within ``frac`` of its reference leaf's largest
    magnitude."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k] - w).max())
        assert err <= frac * scale, (k, err, scale)


def _grads(params, batch, cfg):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    out = TM.forward_train(tree_map(lambda _: next(it), params), batch, cfg)
    grads = iter(torch.autograd.grad(out["loss"], leaves))
    return out, tree_map(lambda _: next(grads), params)


# ------------------------------------------------------------ forward_train
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_and_grads_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jb, tb = _batch(jcfg)

    def loss_fn(p, b):
        out = JM.forward_train(p, b, jcfg)
        return out["loss"], out

    (_, jo), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp, jb)
    to, tg = _grads(tp, tb, tcfg)
    for name in ("loss", "main_loss"):  # 1e-5 relative
        np.testing.assert_allclose(float(to[name].detach()), float(jo[name]), rtol=1e-5)
    assert to["branch_losses"].keys() == jo["branch_losses"].keys()
    for k, v in jo["branch_losses"].items():
        np.testing.assert_allclose(float(to["branch_losses"][k].detach()), float(v), rtol=1e-5)
    assert float(to["aux_loss"]) == 0.0
    flat = _torch_flat(tg)
    assert all(np.isfinite(g).all() for g in flat.values())  # Mamba2's -inf masks
    _assert_tree_close(flat, _jax_flat(jg), 1e-4)


def test_forward_train_with_mask_matches_reference():
    """A token mask (OLMo-1B smoke config): the masked mean of every head,
    loss 1e-5 relative, gradients 1e-4 of each leaf's scale."""
    jcfg, tcfg = _cfgs("olmo_1b")
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jb, tb = _batch(jcfg, b=3, s=16)
    mask = np.random.default_rng(2).random((3, 16)) < 0.6
    jb["mask"], tb["mask"] = jnp.asarray(mask), torch.from_numpy(mask)

    def loss_fn(p, b):
        return JM.forward_train(p, b, jcfg)["loss"]

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(jp, jb)
    to, tg = _grads(tp, tb, tcfg)
    np.testing.assert_allclose(float(to["loss"].detach()), float(jl), rtol=1e-5)
    _assert_tree_close(_torch_flat(tg), _jax_flat(jg), 1e-4)


def test_olmo_configs_match_reference():
    from repro.configs import get_config
    from repro_torch.configs import get_config as tconfig

    assert dataclasses.asdict(tconfig("olmo-1b")) == dataclasses.asdict(get_config("olmo_1b"))
    assert dataclasses.asdict(tsmoke("olmo_1b")) == dataclasses.asdict(
        get_smoke_config("olmo_1b"))


def test_olmo_nonparametric_ln_and_tied_embedding():
    """OLMo's norm is the population-variance LayerNorm at eps 1e-5 with
    no params; the tied embedding takes gradients from both the lookup and
    the unembedding."""
    jcfg, tcfg = _cfgs("olmo_1b")
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert tp["final_norm"] == {} and tp["blocks"]["norm1"] == {}
    assert tp["branches"] == {} and "lm_head" not in tp
    x = torch.randn(3, 5, 64, generator=torch.Generator().manual_seed(1)) * 3 + 1
    want = JM.norm_apply("nonparametric_ln", {}, jnp.asarray(x.numpy()))
    got = TM.norm_apply("nonparametric_ln", {}, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    _, tb = _batch(jcfg, b=2, s=8)
    tokens_only = dict(tb, tokens=torch.zeros_like(tb["tokens"]))
    _, g = _grads(tp, tokens_only, tcfg)
    rows = g["embed"].abs().sum(-1) > 0
    assert rows.sum() > 1  # the unembedding reaches every row, not only token 0


def test_audio_frontend_on_a_vlm_trunk_runs_text_only():
    """A vlm trunk under ``frontend="audio"`` embeds its tokens alone, as
    the reference does (only an ``audio`` trunk runs the encoder): the
    batch's frame embeddings are left unread, no position is dropped from
    the loss, and the losses equal the reference's within 1e-5
    relative."""
    jcfg, tcfg = _cfgs("internvl2_76b", frontend="audio")
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(4), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jb, tb = _batch(jcfg, b=2, s=8)
    assert "frame_embeds" in tb and "patch_embeds" not in tb
    jo = jax.jit(lambda p, b: JM.forward_train(p, b, jcfg))(jp, jb)
    with torch.no_grad():
        to = TM.forward_train(tp, tb, tcfg)
        h, _ = TM._embed_inputs(tp, tb, tcfg)
    assert h.shape == (2, 8, tcfg.d_model)
    for name in ("loss", "main_loss"):
        np.testing.assert_allclose(float(to[name]), float(jo[name]), rtol=1e-5)


def test_remat_matches_no_remat():
    """``cfg.remat`` recomputes each layer in the backward pass: loss and
    every gradient equal bitwise to the run that saves activations."""
    jcfg, tcfg = _cfgs("zamba2_1_2b", num_layers=3, attn_every=2)
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    _, tb = _batch(jcfg, b=2, s=24)
    out0, g0 = _grads(tp, tb, tcfg)
    out1, g1 = _grads(tp, tb, dataclasses.replace(tcfg, remat=True))
    assert torch.equal(out0["loss"].detach(), out1["loss"].detach())
    for (k, a), b in zip(tree_items(g0), tree_leaves(g1)):
        assert torch.equal(a, b), k


def test_stacked_grads_have_no_per_layer_select():
    """The trunk unbinds each stacked leaf once per forward: the one
    consumer of every stacked block param in the backward graph is an
    unbind, never a per-layer select (whose backward is stack-sized)."""
    _, tcfg = _cfgs("olmo_1b", num_layers=4)
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tp = tree_map(lambda p: p.requires_grad_(True), tp)
    out = TM.forward_train(tp, {"tokens": torch.zeros(1, 4, dtype=torch.long),
                                "labels": torch.zeros(1, 4, dtype=torch.long)}, tcfg)
    consumers: dict[int, set] = {}
    seen, stack = set(), [out["loss"].grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            if hasattr(nxt, "variable"):
                consumers.setdefault(id(nxt.variable), set()).add(type(fn).__name__)
            stack.append(nxt)
    blocks = tree_leaves(tp["blocks"])
    assert len(blocks) == 7
    for leaf in blocks:
        assert consumers[id(leaf)] == {"UnbindBackward0"}


def test_unstack_holds_only_the_range():
    """``unstack(tree, lo, hi)`` keys layers [lo, hi) by index, each leaf a
    view of its stack equal to :func:`layer_slice`'s; a narrow range (a
    served segment, one profiled layer) unbinds no other layer."""
    tree = {"a": torch.arange(24.0).reshape(4, 6),
            "b": {"c": torch.arange(8.0).reshape(4, 2)}}
    part = unstack(tree, 1, 3)
    assert sorted(part) == [1, 2]
    for i, layer in part.items():
        ref = layer_slice(tree, i)
        assert torch.equal(layer["a"], ref["a"]) and torch.equal(layer["b"]["c"], ref["b"]["c"])
        assert layer["a"].data_ptr() == tree["a"][i].data_ptr()
    assert sorted(unstack(tree, 0, 4)) == [0, 1, 2, 3]
    assert unstack(tree, 2, 2) == {}


# ----------------------------------------------------------- attention
@pytest.mark.parametrize("g,window", [(1, 0), (2, 0), (2, 5)])
def test_flash_attention_backward(monkeypatch, g, window):
    """The recompute backward against plain autograd of
    ``prefill_attention`` and the reference's ``_flash_vjp`` (1e-5 of each
    gradient's largest magnitude), over 3 query blocks of 16."""
    monkeypatch.setattr(TAttn, "_BLOCK_Q", 16)
    rng = np.random.default_rng(g + window)
    b, s, kh, d = 2, 40, 2, 8
    q = rng.standard_normal((b, s, kh, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    dout = rng.standard_normal((b, s, kh, g, d)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)

    def grads(fn):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = fn(*ts, torch.from_numpy(pos))
        return [out.detach().numpy(),
                *(x.numpy() for x in torch.autograd.grad(out, ts, torch.from_numpy(dout)))]

    flash = grads(lambda *a: TAttn.FlashAttention.apply(*a, window))
    plain = grads(lambda *a: TAttn.prefill_attention(*a, window=window))
    jout, vjp = jax.vjp(
        lambda q_, k_, v_: JAttn.flash_attention(q_, k_, v_, jnp.asarray(pos), jnp.asarray(pos),
                                                 window=window, block_k=16),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(jout), *(np.asarray(x) for x in vjp(jnp.asarray(dout)))]
    for name, a, p, r in zip(("out", "dq", "dk", "dv"), flash, plain, ref):
        np.testing.assert_array_equal(a, p) if name == "out" else None
        for other in (p, r):
            assert np.abs(a - other).max() <= 1e-5 * np.abs(other).max(), name


# ----------------------------------------------------------- optimizers
def _opt_inputs():
    rng = np.random.default_rng(4)
    params = {"a": {"w": rng.standard_normal((6, 5)), "s": rng.standard_normal((3, 4, 5))},
              "b": rng.standard_normal(7), "c": np.asarray(0.7)}
    grads = jax.tree.map(lambda p: 3 * rng.standard_normal(np.shape(p)), params)
    cast = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    return cast(params), cast(grads)


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            tree_map(lambda a: torch.from_numpy(np.array(a)), tree,
                     is_leaf=lambda x: isinstance(x, np.ndarray)))


def _to_np(tree):
    return {"##".join(map(str, p)): t.numpy() for p, t in tree_items(tree)}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_one_update_matches_reference(name):
    """Two updates (the first clipped, at a cosine-scheduled lr) on the same
    gradients: params and state elementwise within 1e-6 relative."""
    params, grads = _opt_inputs()
    jopt = JO.make_optimizer(name, lr=JO.cosine_schedule(1e-2, 2, 10))
    topt = TO.make_optimizer(name, lr=TO.cosine_schedule(1e-2, 2, 10))
    (jp, tp), (jg, tg) = _both(params), _both(grads)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in (3, 4):
        jp, js = jopt.update(jg, js, jp, jnp.asarray(step, jnp.int32))
        tp, ts = topt.update(tg, ts, tp, torch.tensor(step, dtype=torch.int32))
    for got, want in ((_to_np(tp), _jax_flat(jp)), (_to_np(ts), _jax_flat(js))):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_minimizes_quadratic(name):
    """The reference test's inputs: 200 steps on w^2 + b^2."""
    opt = TO.make_optimizer(name, lr=0.1 if name == "adamw" else 0.5)
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(1.5)}
    state = opt.init(params)

    def loss(p):
        return (p["w"] ** 2).sum() + p["b"] ** 2

    l0 = float(loss(params))
    for step in range(200):
        g = {k: 2 * v for k, v in params.items()}
        params, state = opt.update(g, state, params, torch.tensor(step))
    assert float(loss(params)) < l0 * 1e-2


def test_adamw_lr_zero_moves_nothing_and_adafactor_state_shapes():
    opt = TO.adamw(lr=0.0, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(1.5)}
    p2, _ = opt.update({k: torch.zeros_like(v) for k, v in params.items()},
                       opt.init(params), params, torch.tensor(0))
    assert torch.equal(p2["w"], params["w"])
    st = TO.adafactor().init({"m": torch.zeros(8, 16), "v": torch.zeros(5)})
    assert st["m"]["vr"].shape == (8,) and st["m"]["vc"].shape == (16,)
    assert st["v"]["v"].shape == (5,)


def test_cosine_schedule_matches_reference():
    jlr, tlr = JO.cosine_schedule(1e-3, 10, 100), TO.cosine_schedule(1e-3, 10, 100)
    assert float(tlr(torch.tensor(0))) == 0.0
    assert float(tlr(torch.tensor(10))) == pytest.approx(1e-3, rel=1e-5)
    assert float(tlr(torch.tensor(100))) == pytest.approx(1e-4, rel=1e-3)
    for s in (0, 3, 10, 37, 99, 100, 150):
        assert float(tlr(torch.tensor(s, dtype=torch.int32))) == pytest.approx(
            float(jlr(jnp.asarray(s, jnp.int32))), rel=1e-6)


# ----------------------------------------------------------- the train step
@pytest.fixture(scope="module")
def olmo_run():
    """The reference's 3 jitted AdamW steps on the OLMo-1B smoke config
    (fp32, accum 1), the state after each, and the port's params."""
    jcfg, tcfg = _cfgs("olmo_1b", grad_accum=1)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jopt = JO.make_optimizer("adamw", lr=JO.cosine_schedule(3e-3, 1, 10))
    jstep = jax.jit(JT.make_train_step(jcfg, jopt))
    jb, tb = _batch(jcfg, b=4, s=16)
    states, metrics = [JT.init_train_state(jp, jopt)], []
    for _ in range(3):
        st, m = jstep(states[-1], jb)
        states.append(st)
        metrics.append(m)
    return jcfg, tcfg, jp, tb, states, metrics


def test_three_steps_match_reference(olmo_run):
    """Losses, main losses and gradient norms of each step to 1e-5
    relative.  Params after 3 steps: Adam divides each gradient entry by
    its own RMS, so an entry whose gradient is near zero can take a step of
    the other sign after an fp32 difference in the last bits: every entry
    within 2 x the summed learning rate (the most two such steps can part),
    and at most 0.1% of each leaf's entries beyond 1e-4 of its largest
    magnitude (under 0.01% seen)."""
    jcfg, tcfg, jp, tb, states, metrics = olmo_run
    topt = TO.make_optimizer("adamw", lr=TO.cosine_schedule(3e-3, 1, 10))
    step = TT.make_train_step(tcfg, topt)
    st = TT.init_train_state(bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
                             topt)
    for m in metrics:
        st, tm = step(st, tb)
        for k in ("loss", "main_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(m[k]), rtol=1e-5, err_msg=k)
    assert int(st["step"]) == 3
    got, want = _torch_flat(st["params"]), _jax_flat(states[-1]["params"])
    lr = TO.cosine_schedule(3e-3, 1, 10)
    bound = 2 * sum(float(lr(torch.tensor(s))) for s in range(3))
    assert got.keys() == want.keys()
    for k in want:
        d = np.abs(got[k] - want[k])
        assert d.max() <= bound, k
        assert (d > 1e-4 * np.abs(want[k]).max()).mean() <= 1e-3, k


def test_bridged_state_takes_the_same_next_step(olmo_run):
    """The reference's state after 2 steps (params, AdamW m / v, step)
    carried through the bridge: the port's 3rd step equals the reference's
    (loss 1e-5 relative, params and moments 1e-4 of their scale)."""
    jcfg, tcfg, _, tb, states, metrics = olmo_run
    topt = TO.make_optimizer("adamw", lr=TO.cosine_schedule(3e-3, 1, 10))
    st = bridge.train_state_from_jax(jax.tree.map(np.asarray, states[2]), "cpu")
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 2
    st, tm = TT.make_train_step(tcfg, topt)(st, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(metrics[2]["loss"]), rtol=1e-5)
    for part in ("params", "opt"):
        _assert_tree_close(_torch_flat(st[part]), _jax_flat(states[3][part]), 1e-4)
    with pytest.raises(ValueError):
        bridge.train_state_from_jax({"params": {}}, "cpu")


def test_bridged_adafactor_state_takes_the_same_next_step():
    jcfg, tcfg = _cfgs("phi3_mini_3_8b", grad_accum=1)
    jp = JM.init_params(jax.random.PRNGKey(2), jcfg)
    jopt, topt = JO.make_optimizer("adafactor"), TO.make_optimizer("adafactor")
    jb, tb = _batch(jcfg, b=2, s=12)
    jstep = jax.jit(JT.make_train_step(jcfg, jopt))
    s1, _ = jstep(JT.init_train_state(jp, jopt), jb)
    s2, m2 = jstep(s1, jb)
    st = bridge.train_state_from_jax(jax.tree.map(np.asarray, s1), "cpu")
    assert {"vr", "vc"} <= st["opt"]["blocks"]["attn"]["wq"].keys()
    st, tm = TT.make_train_step(tcfg, topt)(st, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(m2["loss"]), rtol=1e-5)
    for part in ("params", "opt"):
        _assert_tree_close(_torch_flat(st[part]), _jax_flat(s2[part]), 1e-4)


def test_grad_accum_matches_full_batch():
    """The reference test's check: accum 2 == accum 1 on one batch (loss
    5e-3 relative; params rtol 5e-2, atol 5e-4), and the accum-2 loss
    against the reference's accum-2 step (1e-5 relative)."""
    jcfg, tcfg = _cfgs("phi3_mini_3_8b")
    jp = JM.init_params(jax.random.PRNGKey(2), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    opt = TO.make_optimizer("adamw", lr=1e-3)
    jb, tb = _batch(jcfg, b=4, s=16, seed=3)
    s1, m1 = TT.make_train_step(tcfg, opt, accum=1)(TT.init_train_state(tp, opt), tb)
    s2, m2 = TT.make_train_step(tcfg, opt, accum=2)(TT.init_train_state(tp, opt), tb)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=5e-3)
    assert "main_loss" in m1 and "main_loss" not in m2
    for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-2, atol=5e-4)
    jopt = JO.make_optimizer("adamw", lr=1e-3)
    _, jm2 = JT.make_train_step(jcfg, jopt, accum=2)(JT.init_train_state(jp, jopt), jb)
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(jm2["grad_norm"]), rtol=1e-5)


def test_loss_decreases():
    """The reference test's check: 12 steps on one batch overfit it."""
    _, tcfg = _cfgs("olmo_1b")
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    opt = TO.make_optimizer("adamw", lr=1e-3)
    state, step = TT.init_train_state(params, opt), TT.make_train_step(tcfg, opt)
    tokens = torch.randint(0, tcfg.vocab_size, (8, 32), generator=torch.Generator().manual_seed(1))
    losses = []
    for _ in range(12):
        state, m = step(state, {"tokens": tokens, "labels": tokens})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] and int(state["step"]) == 12
    assert torch.equal(params["embed"], TM.init_params(
        tcfg, torch.Generator().manual_seed(0), "cpu")["embed"])  # inputs untouched


# ----------------------------------------------------------- checkpoints
def _ck_tree():
    rng = np.random.default_rng(5)
    return {"a": {"w": rng.standard_normal((2, 3)).astype(np.float32),
                  "h": rng.standard_normal((4,)).astype(np.float32)},
            "b": np.asarray(7, np.int32)}


def test_checkpoint_port_to_reference_bitwise():
    """A port checkpoint with a bf16 leaf restores bitwise in the
    reference, and in the port."""
    tree = _ck_tree()
    t = tree_map(lambda a: torch.from_numpy(a), tree, is_leaf=lambda x: isinstance(x, np.ndarray))
    t["a"]["h"] = t["a"]["h"].to(torch.bfloat16)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ck.npz")
        TC.save_checkpoint(path, t, step=42)
        assert set(os.listdir(d)) == {"ck.npz"}
        man = JC.checkpoint_manifest(path)
        assert man["step"] == 42 and man["keys"]["a##h"]["dtype"] == "bfloat16"
        like = {"a": {"w": jax.ShapeDtypeStruct((2, 3), jnp.float32),
                      "h": jax.ShapeDtypeStruct((4,), jnp.bfloat16)},
                "b": jax.ShapeDtypeStruct((), jnp.int32)}
        out = JC.restore_checkpoint(path, like)
        np.testing.assert_array_equal(out["a"]["w"], tree["a"]["w"])
        assert out["a"]["h"].dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(out["a"]["h"], np.float32),
                                      t["a"]["h"].float().numpy())
        assert int(out["b"]) == 7
        back = TC.restore_checkpoint(path, t, "cpu")
        for a, b in zip(tree_leaves(back), tree_leaves(t)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_reference_to_port_bitwise():
    """A reference checkpoint (bf16 leaf stored as 2-byte void) restores
    bitwise in the port, partially: extra keys ignored."""
    tree = _ck_tree()
    jt = {"a": {"w": jnp.asarray(tree["a"]["w"]),
                "h": jnp.asarray(tree["a"]["h"]).astype(jnp.bfloat16)},
          "b": jnp.asarray(tree["b"]), "extra": jnp.zeros(3)}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ck.npz")
        JC.save_checkpoint(path, jt, step=3)
        like = {"a": {"w": torch.empty(2, 3, device="meta"),
                      "h": torch.empty(4, dtype=torch.bfloat16, device="meta")},
                "b": torch.empty((), dtype=torch.int32, device="meta")}
        out = TC.restore_checkpoint(path, like, "cpu")
        np.testing.assert_array_equal(out["a"]["w"].numpy(), tree["a"]["w"])
        assert out["a"]["h"].dtype == torch.bfloat16
        np.testing.assert_array_equal(out["a"]["h"].float().numpy(),
                                      np.asarray(jt["a"]["h"].astype(jnp.float32)))
        assert out["b"].dtype == torch.int32 and int(out["b"]) == 7
        assert TC.checkpoint_manifest(path)["step"] == 3


def test_checkpoint_shape_mismatch_and_missing_key_raise():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ck.npz")
        TC.save_checkpoint(path, {"w": torch.zeros(2, 2)})
        with pytest.raises(ValueError):
            TC.restore_checkpoint(path, {"w": torch.empty(3, 2)}, "cpu")
        with pytest.raises(KeyError):
            TC.restore_checkpoint(path, {"w": torch.empty(2, 2), "v": torch.empty(2)}, "cpu")


# ----------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["olmo_1b", "phi3_mini_3_8b", "whisper_medium",
                                  "internvl2_76b"])
def test_make_batch_bitwise(arch):
    """Text, audio and vision frontends (a reference config carried over
    by its fields)."""
    jcfg = get_smoke_config(arch)
    want = JD.make_batch(jcfg, 3, 24, seed=11)
    got = TD.make_batch(ModelConfig(**dataclasses.asdict(jcfg)), 3, 24, seed=11)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    it = iter(TD.SyntheticLM(ModelConfig(**dataclasses.asdict(jcfg)), 3, 24, seed=10))
    next(it)
    np.testing.assert_array_equal(next(it)["tokens"], want["tokens"])


def test_distort_embeddings():
    e = torch.zeros(64, 128, dtype=torch.bfloat16)
    outs = {name: TD.distort_embeddings(torch.Generator().manual_seed(0), e, lvl)
            for name, lvl in TD.DISTORTIONS.items()}
    assert all(o.dtype == torch.bfloat16 and o.shape == e.shape for o in outs.values())
    stds = [float(outs[n].float().std()) for n in ("low", "mid", "high")]
    assert stds == pytest.approx([0.1, 0.5, 2.0], rel=0.05)


# ----------------------------------------------------------- the example
def test_train_branchy_example_runs(tmp_path, capsys):
    out = train_branchy.main(["--steps", "3", "--device", "cpu",
                              "--ckpt", str(tmp_path / "ck.npz")])
    text = capsys.readouterr().out
    assert "checkpoint round-trip OK (bitwise)" in text
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert sum(out["exit_fractions"]) == pytest.approx(1.0)
    assert sum(out["launches"].values()) == 0  # plain versions on the CPU
