"""Every architecture the port runs (``repro_torch.configs.ARCH_IDS``)
through both packages on the CPU, on weights carried by
``repro_torch.bridge``: the reference's ``tests/test_smoke_archs.py``
checks (a train step, its gradients, a prefill then a decode step), each
case of one test per check; InternVL2's vision path (patch embeddings
before the tokens, the patch logits every training head drops, the
engine's prompt length); and the parameter draw that casts each leaf as
it is drawn.  Whisper's own checks are in ``test_torch_whisper.py``.

Smoke configs at fp32 compute and fp32 params, so that the two packages
agree to the fp32 tolerances of ``test_torch_training.py``: losses 1e-5
relative, every gradient leaf within 1e-4 of its largest magnitude;
prefill and decode logits and branch entropies within 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_smoke
from repro.models import model as JM
from repro.serving import ServingEngine as JServingEngine
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, ModelConfig, get_config, get_smoke_config
from repro_torch.models import model as TM
from repro_torch.models.layers import norm_init, truncated_normal_
from repro_torch.serving import ServingEngine
from repro_torch.training.tree import tree_items, tree_leaves, tree_map

FP32 = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (this file takes gradients; the test run's
    workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(j_smoke(arch), **{"dtype": "float32",
                                                 "param_dtype": "float32", **kw})
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(cfg, batch=2, seq=16, seed=0):
    """The reference smoke test's inputs, drawn with numpy: a vision
    prompt is ``num_patches`` patch embeddings and ``seq - num_patches``
    tokens, its labels the tokens; an audio prompt adds its
    ``encoder_seq_len`` frame embeddings."""
    r = np.random.default_rng(seed)
    text = seq - (cfg.num_patches if cfg.frontend == "vision" else 0)
    toks = r.integers(0, cfg.vocab_size, (batch, text)).astype(np.int32)
    out = {"tokens": toks, "labels": toks}
    if cfg.frontend == "vision":
        out["patch_embeds"] = r.standard_normal(
            (batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.arch_type == "audio":
        out["frame_embeds"] = r.standard_normal(
            (batch, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return out


def _key(path) -> str:
    return "##".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jcfg, _ = _cfgs(arch)
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(42), jcfg)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@functools.lru_cache(maxsize=None)
def _train_both(arch):
    """forward_train's outputs and gradients in both packages (one jitted
    ``jax.value_and_grad``, shared by the train-step and grads checks)."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _weights(arch)
    nb = _inputs(jcfg)

    def loss_fn(p, b):
        out = JM.forward_train(p, b, jcfg)
        return out["loss"], out

    (_, jo), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    tb = {k: _t(v).long() if v.dtype == np.int32 else _t(v) for k, v in nb.items()}
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
    it = iter(leaves)
    to = TM.forward_train(tree_map(lambda _: next(it), tp), tb, tcfg)
    grads = torch.autograd.grad(to["loss"], leaves)
    tg = {"##".join(map(str, p)): g.numpy() for (p, _), g in zip(tree_items(tp), grads)}
    jg = {_key(p): np.asarray(a) for p, a in jax.tree_util.tree_leaves_with_path(jg)}
    return jo, to, jg, tg


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_is_the_reference_s(arch):
    """Published and smoke configs field for field, and the conversion
    ``ModelConfig(**asdict(cfg))`` either way."""
    for port, ref in ((get_config(arch), j_get_config(arch)),
                      (get_smoke_config(arch), j_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert ModelConfig(**dataclasses.asdict(ref)) == port
        assert type(ref)(**dataclasses.asdict(port)) == ref


def test_arch_ids():
    """All ten of the reference's configs."""
    from repro.configs import ARCH_IDS as J_ARCH_IDS

    assert len(ARCH_IDS) == 10
    assert set(ARCH_IDS) == set(J_ARCH_IDS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_tree_is_the_reference_s(arch):
    """The port's own draw: the reference's tree, leaf shapes and dtypes."""
    jcfg, tcfg = _cfgs(arch)
    jp, _ = _weights(arch)
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    got = {"##".join(map(str, p)): tuple(t.shape) for p, t in tree_items(tp)}
    assert got == {_key(p): a.shape for p, a in jax.tree_util.tree_leaves_with_path(jp)}


# ------------------------------------------------------------ the three checks
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_reference(arch):
    """forward_train: the loss, main loss, router aux and each branch's
    loss (DeepSeek-V3's multi-token prediction among them, as ``mtp``)
    within 1e-5 relative, all finite, every branch present."""
    jcfg, _ = _cfgs(arch)
    jo, to, _, _ = _train_both(arch)
    for name in ("loss", "main_loss", "aux_loss"):
        got = float(to[name].detach())
        assert np.isfinite(got)
        np.testing.assert_allclose(got, float(jo[name]), rtol=1e-5, atol=1e-7)
    assert to["branch_losses"].keys() == jo["branch_losses"].keys() == {
        f"branch_{b}" for b in jcfg.branch_layers} | ({"mtp"} if jcfg.use_mtp else set())
    for k, v in jo["branch_losses"].items():
        np.testing.assert_allclose(float(to["branch_losses"][k].detach()), float(v),
                                   rtol=1e-5)
    assert (float(to["aux_loss"].detach()) > 0) == (jcfg.arch_type == "moe")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_grads_match_reference(arch):
    """Every gradient leaf finite and within 1e-4 of the reference leaf's
    largest magnitude."""
    _, _, jg, tg = _train_both(arch)
    assert tg.keys() == jg.keys()
    for k, w in jg.items():
        assert np.isfinite(tg[k]).all(), k
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(tg[k] - w).max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_then_decode_matches_reference(arch):
    """A prompt of 16 positions (a vision prompt: its patches, then its
    tokens; an audio prompt also its frames, which take no position)
    prefilled into a 64-slot cache, then one decode step at position 16:
    logits and branch entropies within 1e-4, lengths exact."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _weights(arch)
    nb = _inputs(jcfg)
    batch, seq = nb["tokens"].shape[0], 16
    jin = {k: jnp.asarray(v) for k, v in nb.items() if k != "labels"}
    jl, jc = jax.jit(JM.prefill, static_argnums=2)(jp, jin, jcfg,
                                                   JM.init_caches(jcfg, batch, 64))
    tpc = TM.compute_params(tp, torch.float32)
    extra = {k: _t(nb[k]) for k in ("patch_embeds", "frame_embeds") if k in nb}
    tl, tc = TM.prefill(tpc, _t(nb["tokens"]).long(), tcfg,
                        TM.init_caches(tcfg, batch, 64, device="cpu"), **extra)
    assert tl.shape == (batch, 1, tcfg.padded_vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32)
    assert int(tc["length"]) == int(jc["length"]) == seq
    tok = np.argmax(np.asarray(jl[:, 0]), -1)[:, None].astype(np.int32)
    jdec = jax.jit(lambda p, t, c: JM.decode_step(p, t, jnp.asarray(seq, jnp.int32), c,
                                                  jcfg, use_kernels=False))
    jo = jdec(jp, jnp.asarray(tok), jc)
    to = TM.decode_step(tpc, _t(tok).long(), seq, tc, tcfg)
    np.testing.assert_allclose(to["logits"].numpy(), np.asarray(jo["logits"]), **FP32)
    assert to["branch_entropy"].keys() == jo["branch_entropy"].keys()
    for layer, e in jo["branch_entropy"].items():
        assert np.isfinite(to["branch_entropy"][layer].numpy()).all()
        np.testing.assert_allclose(to["branch_entropy"][layer].numpy(), np.asarray(e),
                                   atol=1e-4)
    assert int(to["caches"]["length"]) == int(jo["caches"]["length"]) == seq + 1


# ------------------------------------------------------------ the vision path
VLM = "internvl2_76b"


def test_embed_inputs_prepends_the_patches():
    """bf16 compute: the patch embeddings (cast to bf16) then the token
    embeddings, bitwise the reference's; positions 0..P+S-1."""
    jcfg, tcfg = _cfgs(VLM, dtype="bfloat16")
    jp, tp = _weights(VLM)
    nb = _inputs(jcfg)
    jh, jpos = JM._embed_inputs(jp, {k: jnp.asarray(v) for k, v in nb.items()}, jcfg)
    th, tpos = TM._embed_inputs(
        tp, {"tokens": _t(nb["tokens"]).long(), "patch_embeds": _t(nb["patch_embeds"])},
        tcfg)
    assert th.dtype == torch.bfloat16 and th.shape == (2, 16, tcfg.d_model)
    np.testing.assert_array_equal(th.float().numpy(), np.asarray(jh.astype(jnp.float32)))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(th[:, :jcfg.num_patches].float().numpy(),
                                  nb["patch_embeds"].astype(jnp.bfloat16).astype(np.float32))
    with pytest.raises(ValueError):
        TM._embed_inputs(tp, {"tokens": _t(nb["tokens"]).long()}, tcfg)


def test_forward_train_drops_the_patch_logits():
    """Each head's loss reads the text positions' logits only: the main
    loss is the cross-entropy of logits[:, P:] (token t predicting label
    t + 1), recomputed here by hand from the trunk, and equals the
    reference's (1e-5 relative)."""
    jcfg, tcfg = _cfgs(VLM)
    jo, to, _, _ = _train_both(VLM)
    _, tp = _weights(VLM)
    nb = _inputs(jcfg)
    inputs = {"tokens": _t(nb["tokens"]).long(), "patch_embeds": _t(nb["patch_embeds"])}
    with torch.no_grad():
        h, pos = TM._embed_inputs(tp, inputs, tcfg)
        h2, _, _, col = TM.run_trunk(tp, h, tcfg, pos, collect=tcfg.branch_layers)
        logits = TM._unembed(tp, TM.norm_apply(tcfg.norm_type, tp["final_norm"], h2), tcfg)
        p = jcfg.num_patches
        assert logits.shape[1] == p + nb["tokens"].shape[1]
        main = TM.softmax_xent(logits[:, p:][:, :-1], inputs["tokens"][:, 1:])
    np.testing.assert_allclose(float(main), float(to["main_loss"].detach()), rtol=1e-6)
    np.testing.assert_allclose(float(main), float(jo["main_loss"]), rtol=1e-5)


def test_engine_start_counts_the_patches():
    """The K=1 ``ServingEngine`` on a 4-layer InternVL2 smoke config (branches
    1 and 3): ``start`` sets ``pos`` to num_patches + the prompt length, as
    the reference engine does; its last logits within 1e-4 and three
    greedy steps' tokens equal to the reference engine's."""
    jcfg, tcfg = _cfgs(VLM, num_layers=4, branch_layers=(1, 3))
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(3), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    nb = _inputs(jcfg, batch=4, seq=20, seed=4)
    jeng = JServingEngine(jcfg, jp, context_len=64, use_kernels=False)
    teng = ServingEngine(tcfg, tp, context_len=64, device="cpu")
    jst = jeng.start({"tokens": jnp.asarray(nb["tokens"]),
                      "patch_embeds": jnp.asarray(nb["patch_embeds"])})
    tst = teng.start({"tokens": nb["tokens"], "patch_embeds": nb["patch_embeds"]})
    assert tst["pos"] == jst["pos"] == jcfg.num_patches + nb["tokens"].shape[1] == 20
    assert int(tst["caches"]["length"]) == 20
    np.testing.assert_allclose(tst["last_logits"].numpy(), np.asarray(jst["last_logits"]),
                               **FP32)
    jt, _ = jeng.decode(jst, 3)
    tt, _ = teng.decode(tst, 3)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    assert tst["pos"] == jst["pos"] == 23


# ------------------------------------------------------------ init_params
def _parent_init(cfg, generator):
    """The draw before leaves were cast as they came: a dense trunk's
    whole stack drawn in fp32, then every leaf cast to ``param_dtype``."""
    d, ff, n, v = cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.padded_vocab_size

    def proj(d_in, d_out):
        return truncated_normal_(torch.empty((n, d_in, d_out)), generator, d_in ** -0.5)

    def normal(*shape, std):
        return torch.randn(shape, generator=generator).mul_(std)

    def keep(tree):
        if isinstance(tree, dict):
            return {k: keep(x) for k, x in tree.items()}
        return tree.to(torch.bfloat16) if cfg.param_dtype == "bfloat16" else tree

    params = {"embed": keep(normal(v, d, std=0.02))}
    blocks = {"norm1": norm_init(cfg.norm_type, d, "cpu", (n,)),
              "attn": {"wq": proj(d, cfg.q_dim), "wk": proj(d, cfg.kv_dim),
                       "wv": proj(d, cfg.kv_dim), "wo": proj(cfg.q_dim, d)}}
    if cfg.use_qk_norm:
        blocks["attn"]["q_norm"] = {"scale": torch.ones((n, cfg.head_dim))}
        blocks["attn"]["k_norm"] = {"scale": torch.ones((n, cfg.head_dim))}
    blocks["norm2"] = norm_init(cfg.norm_type, d, "cpu", (n,))
    blocks["mlp"] = {"w_gate": proj(d, ff), "w_up": proj(d, ff), "w_down": proj(ff, d)}
    params["blocks"] = keep(blocks)
    params["final_norm"] = keep(norm_init(cfg.norm_type, d, "cpu"))
    if not cfg.tie_embeddings:
        params["lm_head"] = keep(normal(d, v, std=0.02))
    if cfg.branch_layers:
        params["branches"] = keep(norm_init(cfg.norm_type, d, "cpu",
                                            (len(cfg.branch_layers),)))
    return params


@pytest.mark.parametrize("arch", ["qwen3_8b", "phi3_mini_3_8b"])
def test_init_params_bitwise_as_whole_stack_draws(arch):
    """Casting each leaf as it is drawn keeps every existing config's
    weights bitwise: Qwen3-8B's smoke config under its bf16 param_dtype,
    Phi-3-mini's in fp32."""
    cfg = get_smoke_config(arch)
    assert cfg.param_dtype == ("bfloat16" if arch == "qwen3_8b" else "float32")
    got = dict(tree_items(TM.init_params(cfg, torch.Generator().manual_seed(7), "cpu")))
    want = dict(tree_items(_parent_init(cfg, torch.Generator().manual_seed(7))))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
