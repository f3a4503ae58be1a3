"""Multi-token prediction and the two-stack trunk in training: the port's
``forward_train`` under ``use_mtp`` and ``first_k_dense`` against the
reference package's on the CPU, on weights carried by
``repro_torch.bridge``, and one Adafactor step with bf16 gradient
accumulation (DeepSeek-V3's own optimizer settings) against the
reference's train step.

Tolerances, each stated at its check (those of ``test_torch_training.py``
and ``test_torch_moe.py`` for fp32 compute and params):

  * the loss, the main loss, the router aux loss and every branch loss,
    the MTP loss among them: 1e-5 relative;
  * every gradient leaf: within 1e-4 of its largest magnitude;
  * the Adafactor step: loss and gradient norm 1e-5 relative; each
    updated param leaf within 2^-7 of its largest update and each Adafactor
    statistic within 2^-7 of its largest value: two bf16 ulps, because the
    accumulated gradient is rounded to bf16, where an fp32 difference in
    the last bits moves an entry by one ulp (2^-8 of it; 2^-7 of its
    square), and the update divides by statistics that moved with it
    (seen: 0.005 of the update, 2.5e-4 of a statistic).

The MTP block runs on the trunk's output, predicts token t + 2 and weighs
0.3 in the loss; ``branch_losses["mtp"]`` reports it, as in the reference.
Training on the card is not held here: DeepSeek-V3's experts do not fit
one card beside their gradients (see PERF.md).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.data import pipeline as JD
from repro.models import model as JM
from repro.training import optimizer as JO
from repro.training import train_loop as JT
from repro_torch import bridge
from repro_torch.configs import ModelConfig
from repro_torch.models import model as TM
from repro_torch.models.layers import norm_apply
from repro_torch.models.transformer import BlockKind, block_apply
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TT
from repro_torch.training.tree import tree_items, tree_leaves, tree_map

#: (label, arch, overrides): DeepSeek-V3's smoke trunk (MLA, one dense
#: layer then one MoE layer, MTP); OLMo-1B with MTP (a GQA MTP block
#: under the non-parametric LayerNorm, tied embedding); Qwen3-30B-A3B with
#: a dense first layer (``first_k_dense`` on a GQA MoE trunk; its smoke
#: config has no dense width, so d_ff 256) and MTP.
CASES = [
    ("deepseek_v3", "deepseek_v3_671b", {}),
    ("olmo_mtp", "olmo_1b", dict(use_mtp=True)),
    ("qwen3_moe_first_k_dense", "qwen3_moe_30b_a3b",
     dict(first_k_dense=1, d_ff=256, use_mtp=True)),
]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: this file takes gradients of small shapes, and
    the test run's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(j_smoke(arch), **{"dtype": "float32",
                                                 "param_dtype": "float32", **kw})
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _key(path) -> str:
    return "##".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _batch(jcfg, b=2, s=16, seed=0, mask=False):
    nb = JD.make_batch(jcfg, b, s, seed)
    if mask:
        nb["mask"] = (np.random.default_rng(seed).random((b, s)) < 0.7).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _weights(jcfg, seed=0):
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _grads(params, batch, cfg):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    out = TM.forward_train(tree_map(lambda _: next(it), params), batch, cfg)
    grads = iter(torch.autograd.grad(out["loss"], leaves))
    return out, tree_map(lambda _: next(grads), params)


def _assert_tree_close(got: dict, want: dict, frac: float):
    """Every leaf within ``frac`` of its reference leaf's largest
    magnitude."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k] - w).max())
        assert err <= frac * scale, (k, err, scale)


def _torch_flat(tree) -> dict:
    return {"##".join(map(str, p)): t.detach().float().numpy() for p, t in tree_items(tree)}


def _jax_flat(tree) -> dict:
    return {_key(p): np.asarray(a, np.float32)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("mask", [False, True], ids=["all_tokens", "masked"])
@pytest.mark.parametrize("label,arch,over", CASES, ids=[c[0] for c in CASES])
def test_forward_train_with_mtp_matches_reference(label, arch, over, mask):
    """Every loss (the MTP loss as ``branch_losses["mtp"]``) 1e-5
    relative, and every gradient leaf — the MTP block's and ``mtp_norm``'s
    among them — within 1e-4 of its largest magnitude, against a jitted
    ``jax.value_and_grad``; with a loss mask, the MTP head drops the
    masked labels two tokens on."""
    jcfg, tcfg = _cfgs(arch, **over)
    jp, tp = _weights(jcfg)
    jb, tb = _batch(jcfg, mask=mask)

    def loss_fn(p, b):
        out = JM.forward_train(p, b, jcfg)
        return out["loss"], out

    (_, jo), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp, jb)
    to, tg = _grads(tp, tb, tcfg)
    for name in ("loss", "main_loss", "aux_loss"):
        np.testing.assert_allclose(float(to[name].detach()), float(jo[name]), rtol=1e-5,
                                   err_msg=name)
    assert "mtp" in jo["branch_losses"]
    assert to["branch_losses"].keys() == jo["branch_losses"].keys()
    for k, v in jo["branch_losses"].items():
        np.testing.assert_allclose(float(to["branch_losses"][k].detach()), float(v),
                                   rtol=1e-5, err_msg=k)
    want = _jax_flat(jg)
    got = _torch_flat(tg)
    assert got.keys() == want.keys()
    assert any(k.startswith("mtp_block##") for k in want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(got[k] - w).max()) <= 1e-4 * scale, k
    if tcfg.first_k_dense:
        assert float(np.abs(want["dense_blocks##mlp##w_gate"]).max()) > 0


def test_mtp_loss_is_the_block_the_norm_and_labels_two_on():
    """Inside the port: ``branch_losses["mtp"]`` is the cross-entropy of
    ``mtp_norm`` and the unembedding after the MTP block (an MLA dense
    block) on the trunk's output, against labels shifted by 2; the total
    adds it at weight 0.3 to the main, branch and aux terms (exact up to
    fp32 summation order, 1e-6 relative)."""
    _, tcfg = _cfgs("deepseek_v3_671b")
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    _, tb = _batch(tcfg, s=12, seed=4)
    with torch.no_grad():
        out = TM.forward_train(tp, tb, tcfg)
        h, pos = TM._embed_inputs(tp, tb, tcfg)
        h2, _, aux, _ = TM.run_trunk(tp, h, tcfg, pos)
        hm, _ = block_apply(tp["mtp_block"], h2, tcfg, BlockKind("mla", "dense"), pos)
        logits = TM._unembed(tp, norm_apply(tcfg.norm_type, tp["mtp_norm"], hm), tcfg)
        want = TM.softmax_xent(logits[:, :-2], tb["labels"][:, 2:])
    assert torch.equal(out["branch_losses"]["mtp"], want)
    total = (out["main_loss"] + tcfg.branch_loss_weight * out["branch_losses"]["branch_1"]
             + tcfg.router_aux_weight * out["aux_loss"] + 0.3 * want)
    np.testing.assert_allclose(float(out["loss"]), float(total), rtol=1e-6)
    assert float(aux) > 0 and tp["mtp_block"]["attn"]["wkv_a"].dim() == 2


def test_adafactor_step_with_bf16_accumulation_matches_reference():
    """DeepSeek-V3's training settings on its smoke trunk: Adafactor and
    gradient accumulation over 2 microbatches in bf16 (``accum_dtype``),
    one step of ``make_train_step`` in both packages.  Loss and gradient
    norm 1e-5 relative; each updated param within 2^-7 of its leaf's
    largest update and each Adafactor statistic within 2^-7 of its leaf's
    largest value (two bf16 ulps, see the module doc); the MTP block
    moved."""
    jcfg, tcfg = _cfgs("deepseek_v3_671b", grad_accum=2)
    assert (tcfg.optimizer, tcfg.accum_dtype) == ("adafactor", "bfloat16")
    jp, tp = _weights(jcfg, seed=2)
    jb, tb = _batch(jcfg, b=4, s=12, seed=5)
    jopt, topt = JO.make_optimizer("adafactor"), TO.make_optimizer("adafactor")
    js, jm = jax.jit(JT.make_train_step(jcfg, jopt))(JT.init_train_state(jp, jopt), jb)
    ts, tm = TT.make_train_step(tcfg, topt)(TT.init_train_state(tp, topt), tb)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    want, start = _jax_flat(js["params"]), _torch_flat(tp)
    steps = {k: w - start[k] for k, w in want.items()}
    got = {k: g - start[k] for k, g in _torch_flat(ts["params"]).items()}
    _assert_tree_close(got, steps, 2.0 ** -7)
    _assert_tree_close(_torch_flat(ts["opt"]), _jax_flat(js["opt"]), 2.0 ** -7)
    assert int(ts["step"]) == 1
    assert not torch.equal(ts["params"]["mtp_block"]["attn"]["wq_a"],
                           tp["mtp_block"]["attn"]["wq_a"])
