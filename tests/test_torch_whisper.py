"""Whisper-medium in the port (``repro_torch.configs.whisper_medium``: the
tanh-GELU MLP, sinusoidal positions, the encoder, cross-attention over the
encoder frames, audio ``prefill`` / ``decode_step`` / ``forward_train``)
against the reference package on the CPU, on weights carried by
``repro_torch.bridge``; the JAX side is jitted.

Tolerances, each stated at its check:

  * GELU over every finite bf16 input: bitwise the reference's wherever
    input and output exceed 2^-126, within 2^-126 elsewhere (XLA's CPU
    flushes subnormals to zero).  An fp32 sweep over [-12, 12]: 1e-6
    absolute plus 2e-7 relative (the two frameworks' fp32 ``tanh``);
  * the sinusoid table bitwise (both are numpy float64 cast to fp32); the
    device-math embedding within two ulps of its fp32 argument plus 2e-6
    up to position 4,095 (``pow``, ``sin`` and ``cos`` in two
    frameworks), 2e-6 at the first 64 positions;
  * modules in fp32 compute: the encoder, the cross K/V and one decoder
    block within 1e-5 (rtol and atol, ``test_torch_moe.py``'s fp32 module
    tolerance);
  * the smoke model in fp32: prefill and decode logits, branch entropies
    and both caches within 1e-4 (the model tolerance); cache positions and
    lengths exact;
  * ``forward_train`` in fp32: losses 1e-5 relative, every gradient leaf
    within 1e-4 of its largest magnitude (``test_torch_training.py``'s
    bounds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import ModelConfig
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.training.tree import tree_items, tree_leaves, tree_map

ARCH = "whisper_medium"
FP32 = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(rtol=1e-4, atol=1e-4)
#: The smallest normal fp32 (and bf16) magnitude.
TINY = 2.0 ** -126


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these shapes are small, and the test run's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    jcfg = dataclasses.replace(j_smoke(ARCH), **{"dtype": "float32",
                                                 "param_dtype": "float32", **kw})
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _t(a):
    return torch.from_numpy(np.array(a))


def _key(path) -> str:
    return "##".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(5), jcfg)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _inputs(cfg, batch=3, seq=7, seed=0):
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
            "frame_embeds": r.standard_normal(
                (batch, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)}


# ------------------------------------------------------------ layers
def test_gelu_over_every_bf16_value():
    """The port's GELU on all 65,280 finite bf16 inputs: bitwise the
    reference's ``jax.nn.gelu`` (tanh form) wherever input and output
    are above 2^-126; where either is at most that (XLA's CPU flushes
    subnormals to zero, also inside the op chain), within 2^-126 (508
    inputs differ, all there)."""
    x = np.arange(65536, dtype=np.uint16).view(ml_dtypes.bfloat16)
    x = x[np.isfinite(x.astype(np.float32))]
    want = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(x))).astype(np.float32)
    got = TL.gelu(_t(x.astype(np.float32)).to(torch.bfloat16)).float().numpy()
    xf = x.astype(np.float32)
    flushed = (np.abs(xf) <= TINY) | (np.abs(got) <= TINY)
    diff = got != want
    assert x.size == 65280 and diff.sum() == 508
    np.testing.assert_array_equal(got[~flushed], want[~flushed])
    assert np.abs(got[diff] - want[diff]).max() <= TINY
    # The MLP reads it: mlp_apply's gelu branch is w_up, gelu, w_down.
    r = np.random.default_rng(1)
    p = {"w_up": r.standard_normal((8, 16)).astype(np.float32) / 3,
         "w_down": r.standard_normal((16, 8)).astype(np.float32) / 4}
    h = r.standard_normal((2, 3, 8)).astype(np.float32)
    jo = JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(h, jnp.bfloat16), "gelu")
    to = TL.mlp_apply({k: _t(v) for k, v in p.items()}, _t(h).to(torch.bfloat16), "gelu")
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=2.0 ** -7)


def test_gelu_fp32_sweep_and_other_forms():
    """fp32 over [-12, 12] (240,001 points): within 1e-6 absolute plus
    2e-7 relative of the reference (XLA's fp32 ``tanh`` is a rational
    approximation clamped at |z| ~ 7.9, where 1 + tanh(z) cancels to 0
    and torch's leaves a few 1e-7).  The exact (erf) GELU, which torch
    defaults to, misses by over 1e-4 there: it is not the reference's
    function."""
    x = np.linspace(-12, 12, 240001, dtype=np.float32)
    want = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(x)))
    got = TL.gelu(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-6)
    exact = torch.nn.functional.gelu(_t(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


def test_sinusoids_match_reference():
    """The float64 table bitwise; the fp32 device-math embedding at
    positions 0..4095, shared (1,) and per-row (B, 1), within two ulps of
    its argument plus 2e-6 (the angle pos / 10000^(2i/d) is fp32 in both
    packages, and torch's and XLA's ``pow`` and ``sin`` / ``cos`` may part
    by an ulp of an argument up to 4,095 rad); the two forms differ from
    each other, in both packages."""
    for s, d in ((32, 128), (4096, 1024)):
        np.testing.assert_array_equal(TL.sinusoidal_positions(s, d).numpy(),
                                      np.asarray(JL.sinusoidal_positions(s, d)))

    def bound(pos):
        angle = pos[..., None].astype(np.float64) / 10_000.0 ** (
            2 * np.arange(512) / 1024)
        return 2e-6 + 2 * np.spacing(np.float32(np.concatenate([angle, angle], -1)))

    pos = np.arange(4096, dtype=np.int32)
    want = np.asarray(jax.jit(JL.sinusoidal_embed, static_argnums=1)(jnp.asarray(pos), 1024))
    got = TL.sinusoidal_embed(_t(pos), 1024).numpy()
    assert (np.abs(got - want) <= bound(pos)).all()
    assert np.abs(got - want)[:64].max() <= 2e-6  # the prompt's positions
    rows = np.array([[3], [4095], [130]], np.int32)
    want = np.asarray(JL.sinusoidal_embed(jnp.asarray(rows), 1024))
    got = TL.sinusoidal_embed(_t(rows), 1024)
    assert got.shape == (3, 1, 1024)
    assert (np.abs(got.numpy() - want) <= bound(rows)).all()
    table = TL.sinusoidal_positions(4096, 1024)
    assert not torch.equal(TL.sinusoidal_embed(_t(pos), 1024), table)


# ------------------------------------------------------------ modules
def test_encoder_and_cross_kv_match_reference(weights):
    """``encode_audio`` (the sinusoid table added, the causally masked
    encoder stack, its final norm) and ``compute_cross_kv`` (L, B, S_enc,
    Kh, D) in fp32: within 1e-5."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    fe = _inputs(jcfg)["frame_embeds"]
    jenc = jax.jit(JM.encode_audio, static_argnums=2)(jp, jnp.asarray(fe), jcfg)
    tenc = TM.encode_audio(tp, _t(fe), tcfg)
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), **FP32)
    jk, jv = JM.compute_cross_kv(jp, jenc, jcfg)
    tk, tv = TM.compute_cross_kv(tp, tenc, tcfg)
    assert tk.shape == (jcfg.num_layers, 3, jcfg.encoder_seq_len, jcfg.num_kv_heads,
                        jcfg.head_dim)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **FP32)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **FP32)


def test_encoder_is_causal_as_the_reference_s(weights):
    """The reference's encoder masks causally (its ``causal=False`` drops
    only the window): the first frame's encoding does not depend on the
    later frames, in both packages."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    fe = _inputs(jcfg)["frame_embeds"]
    fe2 = fe.copy()
    fe2[:, 1:] += 1.0
    for enc, p, cfg, conv in ((JM.encode_audio, jp, jcfg, jnp.asarray),
                              (TM.encode_audio, tp, tcfg, _t)):
        a, b = (np.asarray(enc(p, conv(x), cfg)) for x in (fe, fe2))
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        assert np.abs(a[:, 1:] - b[:, 1:]).max() > 1e-3


@pytest.mark.parametrize("mode", ["prefill", "decode_rows"])
def test_decoder_block_with_cross_attention_matches_reference(weights, mode):
    """One decoder block (self-attention without RoPE, cross-attention
    over the encoder's K/V, the GELU MLP) in fp32, within 1e-5: a 5-token
    prompt without a cache, and a decode step writing a ring on a
    compacted sub-batch (``rows`` with a sentinel, whose cross K/V row is
    clamped in the port as JAX clamps the gather)."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    kind_j, kind_t = JM.trunk_layout(jcfg)[0][1], TM.trunk_layout(tcfg)[0][1]
    assert (kind_t.cross_attention, kind_t.use_rope, kind_t.causal) == (
        kind_j.cross_attention, kind_j.use_rope, kind_j.causal) == (True, False, True)
    r = np.random.default_rng(2)
    b, s_enc, kh, hd = 4, jcfg.encoder_seq_len, jcfg.num_kv_heads, jcfg.head_dim
    ck = r.standard_normal((b, s_enc, kh, hd)).astype(np.float32)
    cv = r.standard_normal((b, s_enc, kh, hd)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["blocks"])
    tl = TT.layer_slice(tp["blocks"], 0)
    if mode == "prefill":
        x = r.standard_normal((b, 5, jcfg.d_model)).astype(np.float32)
        pos = np.arange(5, dtype=np.int32)
        jh, _, _ = JT.block_apply(jl, jnp.asarray(x), jcfg, kind_j, jnp.asarray(pos),
                                  None, (jnp.asarray(ck), jnp.asarray(cv)))
        th, _ = TT.block_apply(tl, _t(x), tcfg, kind_t, _t(pos),
                               cross_kv=(_t(ck), _t(cv)))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **FP32)
        return
    rows = np.array([2, 0, b], np.int32)  # the last a sentinel
    x = r.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    pos = np.array([4], np.int32)
    jc = {"self": {k: v for k, v in JM.init_caches(jcfg, b, 8, jnp.float32)["blocks"]
                   ["self"].items()}}
    jc = jax.tree.map(lambda a: a[0], jc)
    jc["self"]["length"] = jnp.asarray(4, jnp.int32)
    tc = {"self": {k: _t(np.asarray(v)) for k, v in jc["self"].items()}}
    jh, jnc, _ = JT.block_apply(jl, jnp.asarray(x), jcfg, kind_j, jnp.asarray(pos), jc,
                                (jnp.asarray(ck), jnp.asarray(cv)), rows=jnp.asarray(rows))
    th, _ = TT.block_apply(tl, _t(x), tcfg, kind_t, _t(pos), tc,
                           cross_kv=(_t(ck), _t(cv)), rows=_t(rows).long())
    np.testing.assert_allclose(th[:2].numpy(), np.asarray(jh[:2]), **FP32)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc["self"][k].numpy(), np.asarray(jnc["self"][k]), **FP32)
    np.testing.assert_array_equal(tc["self"]["pos"].numpy(), np.asarray(jnc["self"]["pos"]))


# ------------------------------------------------------------ the model
def _prefill_both(jp, tp, jcfg, tcfg, nb, cap=16):
    b = nb["tokens"].shape[0]
    jl, jc = jax.jit(JM.prefill, static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in nb.items()}, jcfg, JM.init_caches(jcfg, b, cap))
    tpc = TM.compute_params(tp, torch.float32)
    tl, tc = TM.prefill(tpc, _t(nb["tokens"]).long(), tcfg,
                        TM.init_caches(tcfg, b, cap, device="cpu"),
                        frame_embeds=_t(nb["frame_embeds"]))
    return (jl, jc), (tl, tc, tpc)


def test_prefill_logits_and_both_caches_match_reference(weights):
    """A 7-token prompt over 32 frames into a 16-slot ring: last logits,
    the self-attention ring's K and V and the cross K/V of every layer
    within 1e-4; ring positions and lengths exact."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    (jl, jc), (tl, tc, _) = _prefill_both(jp, tp, jcfg, tcfg, _inputs(jcfg))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
    tn = bridge.caches_to_numpy(tc)
    assert isinstance(tn["cross_kv"], tuple) and len(tn["cross_kv"]) == 2
    for got, want in zip(tn["cross_kv"], jc["cross_kv"]):
        np.testing.assert_allclose(got, np.asarray(want), **MODEL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tn["blocks"]["self"][k], np.asarray(jc["blocks"]["self"][k]),
                                   **MODEL)
    for k in ("pos", "length"):
        np.testing.assert_array_equal(tn["blocks"]["self"][k],
                                      np.asarray(jc["blocks"]["self"][k]))
    assert int(tc["length"]) == int(jc["length"]) == 7


def _decode(M, params, tok, positions, caches, cfg, conv):
    """One decode step through ``embed_decode`` and ``run_trunk`` (the tier
    runtime's path; positions (1,) or per row (B, 1)): (logits, branch
    entropies)."""
    h = M.embed_decode(params, conv(tok), positions, cfg)
    h2, caches, _, col = M.run_trunk(params, h, cfg, positions, caches,
                                     collect=cfg.branch_layers)
    logits = M._unembed(params, M.norm_apply(cfg.norm_type, params["final_norm"], h2), cfg)
    _, bl = M.branch_logits_stacked(params, col, cfg)
    return logits[:, 0], bl[:, :, 0]


@pytest.mark.parametrize("positions", ["shared", "per_row"])
def test_decode_matches_reference(weights, positions):
    """Three plain decode steps after the prefill, the sinusoidal embedding
    added at the shared step position or at each row's own (a (B, 1)
    vector, 7 + row + step): logits and branch logits within 1e-4, the
    ring within 1e-4, cross K/V untouched in both packages."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    nb = _inputs(jcfg)
    (jl, jc), (tl, tc, tpc) = _prefill_both(jp, tp, jcfg, tcfg, nb)
    cross0 = [t.clone() for t in tc["cross_kv"]]
    tok = np.argmax(np.asarray(jl[:, 0]), -1)[:, None].astype(np.int32)
    for i in range(3):
        if positions == "shared":
            pos = np.array([7 + i], np.int32)
        else:
            pos = (7 + i + np.arange(3, dtype=np.int32))[:, None]
        if positions == "shared":
            jo = jax.jit(lambda p, t, c, q: JM.decode_step(p, t, q[0], c, jcfg,
                                                           use_kernels=False))(
                jp, jnp.asarray(tok), jc, jnp.asarray(pos))
            jlog, jc = jo["logits"], jo["caches"]
            jbl = jnp.stack([jo["branch_logits"][l] for l in jcfg.branch_layers])
            to = TM.decode_step(tpc, _t(tok).long(), 7 + i, tc, tcfg)
            tlog = to["logits"]
            tbl = torch.stack([to["branch_logits"][l] for l in tcfg.branch_layers])
        else:
            jlog, jbl, jc = jax.jit(lambda p, t, q, c: _j_decode(p, t, q, c, jcfg))(
                jp, jnp.asarray(tok), jnp.asarray(pos), jc)
            tlog, tbl = _decode(TM, tpc, tok, _t(pos), tc, tcfg, lambda a: _t(a).long())
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **MODEL)
        np.testing.assert_allclose(tbl.numpy(), np.asarray(jbl), **MODEL)
        tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    tn = bridge.caches_to_numpy(tc)
    for k in ("k", "v"):
        np.testing.assert_allclose(tn["blocks"]["self"][k], np.asarray(jc["blocks"]["self"][k]),
                                   **MODEL)
    np.testing.assert_array_equal(tn["blocks"]["self"]["pos"],
                                  np.asarray(jc["blocks"]["self"]["pos"]))
    assert all(torch.equal(a, b) for a, b in zip(cross0, tc["cross_kv"]))
    for got, want in zip(tn["cross_kv"], jc["cross_kv"]):
        np.testing.assert_allclose(got, np.asarray(want), **MODEL)


def _j_decode(p, tok, positions, caches, cfg):
    h = JM.embed_decode(p, tok, positions, cfg)
    h2, caches, _, col = JM.run_trunk(p, h, cfg, positions, caches,
                                      collect=cfg.branch_layers)
    logits = JM._unembed(p, JM.norm_apply(cfg.norm_type, p["final_norm"], h2), cfg)
    _, bl = JM.branch_logits_stacked(p, col, cfg)
    return logits[:, 0], bl[:, :, 0], caches


def test_prefill_rows_raises_as_the_reference(weights):
    """Row-targeted admission does not cover the encoder's cross K/V: both
    packages raise ``NotImplementedError``."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    nb = _inputs(jcfg)
    with pytest.raises(NotImplementedError, match="cross-KV"):
        JM.prefill(jp, {k: jnp.asarray(v) for k, v in nb.items()}, jcfg,
                   JM.init_caches(jcfg, 3, 16), rows=jnp.arange(3))
    with pytest.raises(NotImplementedError, match="cross-KV"):
        TM.prefill(tp, _t(nb["tokens"]).long(), tcfg, TM.init_caches(tcfg, 3, 16, device="cpu"),
                   frame_embeds=_t(nb["frame_embeds"]), rows=np.arange(3))
    with pytest.raises(ValueError, match="frame_embeds"):
        TM.prefill(tp, _t(nb["tokens"]).long(), tcfg, TM.init_caches(tcfg, 3, 16, device="cpu"))


# ------------------------------------------------------------ training
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_forward_train_loss_and_grads_match_reference(weights, masked):
    """The joint loss over a batch of ``make_batch`` (the encoder, the
    cross K/V from it, the decoder with remat as the smoke config sets it)
    and every gradient leaf, the encoder's included, against a jitted
    ``jax.value_and_grad``: losses 1e-5 relative, gradients 1e-4 of each
    leaf's largest magnitude; with and without a token mask."""
    from repro.data import pipeline as JD

    jp, tp = weights
    jcfg, tcfg = _cfgs(remat=True)
    nb = JD.make_batch(jcfg, 3, 12, 1)
    assert nb["frame_embeds"].shape == (3, jcfg.encoder_seq_len, jcfg.d_model)
    if masked:
        nb["mask"] = np.random.default_rng(2).random((3, 12)) < 0.6

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
    for name in ("loss", "main_loss"):
        np.testing.assert_allclose(float(to[name].detach()), float(jo[name]), rtol=1e-5)
    assert to["branch_losses"].keys() == jo["branch_losses"].keys() == {"branch_1"}
    np.testing.assert_allclose(float(to["branch_losses"]["branch_1"].detach()),
                               float(jo["branch_losses"]["branch_1"]), rtol=1e-5)
    tg = {"##".join(map(str, p)): g.numpy() for (p, _), g in zip(tree_items(tp), grads)}
    jg = {_key(p): np.asarray(a) for p, a in jax.tree_util.tree_leaves_with_path(jg)}
    assert tg.keys() == jg.keys()
    assert any(k.startswith("encoder") for k in tg)
    for k, w in jg.items():
        assert np.isfinite(tg[k]).all(), k
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(tg[k] - w).max()) <= 1e-4 * scale, k
