"""The port's B-AlexNet and the paper's Fig. 4 / Fig. 5 sweeps
(``repro_torch.models.alexnet``, ``repro_torch.benchmarks``) against the
reference on the CPU.

Weights come from the reference's ``init_b_alexnet(PRNGKey(0))`` through
``bridge.alexnet_params_from_jax`` (NHWC / HWIO -> NCHW / OIHW, fc6's and
b1_fc's input rows permuted), a batch of 2 images at 224 from numpy seed 0.
Both packages compute in fp32 and sum the products in other orders, so
every layer output and both logits are held at rtol = atol = 1e-4 (the
differences seen are ~1e-6 of each output's scale).

The sweeps run the reference's own ``benchmarks/fig4_inference_time.py``
and ``fig5_partition_layer.py`` with their ``profile`` replaced by a fixed
synthetic 8-layer cost list, against the port's ``sweep(costs)`` on the
same list.  The reference solves in float32 (JAX runs without x64 here),
the port in float64, so a split may differ only at a point where the two
splits' float64 costs lie within float32 rounding of each other; each such
point is named and checked, and everywhere else splits are equal.  E[T]
agrees within rtol 1e-5.
"""

import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.models import alexnet as JA
from repro_torch import bridge
from repro_torch.benchmarks import alexnet_profile as tprofile
from repro_torch.benchmarks import fig4_inference_time as tfig4
from repro_torch.benchmarks import fig5_partition_layer as tfig5
from repro_torch.core import LayerCost, chain_costs_torch, output_bytes
from repro_torch.models import alexnet as TA

ROOT = Path(__file__).resolve().parents[1]
NAMES = ["conv1", "conv2", "conv3", "conv4", "conv5", "fc6", "fc7", "fc8"]
TOL = dict(rtol=1e-4, atol=1e-4)
#: Relative gap between two float64 costs that float32 cannot resolve.
F32_TIE = 4 * float(np.finfo(np.float32).eps)

#: A fixed synthetic profile: B-AlexNet's alphas (batch 1, fp32) and
#: seconds per layer chosen so that the sweeps reach splits 0, 1, 2, 5, 8.
T_C = [1.2e-3, 1.5e-3, 0.9e-3, 0.8e-3, 0.6e-3, 1.1e-3, 0.5e-3, 0.01e-3]
ALPHA = [186624.0, 129792.0, 259584.0, 173056.0, 36864.0, 16384.0, 16384.0, 8.0]


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def as_ref_layout(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


@pytest.fixture(scope="module")
def nets():
    """(reference params, port params, images NHWC, the reference's input
    to each layer, its output of each layer)."""
    jp = JA.init_b_alexnet(jax.random.PRNGKey(0))
    tp = bridge.alexnet_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    images = np.random.default_rng(0).standard_normal((2, 224, 224, 3)).astype(np.float32)
    ins, outs, x = [], [], jnp.asarray(images)
    for _, fn in JA.layer_fns(jp):
        ins.append(np.asarray(x))
        x = jax.jit(fn)(x)
        outs.append(np.asarray(x))
    return jp, tp, images, ins, outs


@pytest.mark.parametrize("i", range(8), ids=NAMES)
def test_layer_matches_reference(nets, i):
    _, tp, _, ins, outs = nets
    name, fn = TA.layer_fns(tp)[i]
    assert name == NAMES[i]
    x = ins[i]
    got = fn(nchw(x) if x.ndim == 4 else torch.tensor(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(as_ref_layout(got), outs[i], **TOL)


def test_logits_match_reference(nets):
    jp, tp, images, _, _ = nets
    main_j, branch_j = jax.jit(JA.forward)(jp, jnp.asarray(images))
    main_t, branch_t = TA.forward(tp, nchw(images))
    assert main_t.shape == (2, 2) and branch_t.shape == (2, 2)
    np.testing.assert_allclose(main_t.numpy(), np.asarray(main_j), **TOL)
    np.testing.assert_allclose(branch_t.numpy(), np.asarray(branch_j), **TOL)


def test_bridge_layout_is_a_permutation(nets):
    """Conv weights are the reference's HWIO transposed, fc6's rows are its
    (h, w, c) rows in (c, h, w) order; values transfer bitwise."""
    jp, tp, _, _, _ = nets
    for name in ("conv1", "conv3", "b1_conv"):
        want = np.asarray(jp[name]["w"]).transpose(3, 2, 0, 1)
        assert np.array_equal(tp[name]["w"].numpy(), want)
    ref6, port6 = np.asarray(jp["fc6"]["w"]), tp["fc6"]["w"].numpy()
    for c, h, w in ((0, 0, 0), (255, 5, 5), (17, 2, 4)):
        assert np.array_equal(port6[c * 36 + h * 6 + w], ref6[(h * 6 + w) * 256 + c])
    assert np.array_equal(tp["fc7"]["w"].numpy(), np.asarray(jp["fc7"]["w"]))


def test_output_bytes_match_reference(nets):
    jp, tp, images, _, _ = nets
    x_j = jax.ShapeDtypeStruct(images.shape, jnp.float32)
    x_t = nchw(images)
    for (name, jf), (_, tf) in zip(JA.layer_fns(jp), TA.layer_fns(tp)):
        x_j = jax.eval_shape(jf, x_j)
        x_t = tf(x_t)
        assert output_bytes(x_t) == J.output_bytes(x_j), name


def test_profile_on_the_cpu_names_and_alphas():
    costs = tprofile.profile(device="cpu")
    assert [c.name for c in costs] == NAMES
    want, x = [], jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32)
    for _, fn in JA.layer_fns(JA.init_b_alexnet(jax.random.PRNGKey(0))):
        x = jax.eval_shape(fn, x)
        want.append(J.output_bytes(x))
    assert [c.output_bytes for c in costs] == want
    assert all(c.time_s > 0 for c in costs)
    assert tprofile.RAW_INPUT_BYTES == 224 * 224 * 3 * 4


def test_profile_times_the_given_params(nets, monkeypatch):
    _, tp, _, _, _ = nets
    timed = []
    monkeypatch.setattr(tprofile, "measure_layer_times",
                        lambda fns, inputs, **kw: timed.append((fns, inputs, kw)) or "costs")
    assert tprofile.profile(params=tp) == "costs"
    (fns, inputs, kw), = timed
    assert [n for n, _ in fns] == NAMES and kw == dict(iters=20, warmup=3)
    assert all(t.device.type == "cpu" and not t.any() for t in inputs)
    assert tuple(inputs[0].shape) == (1, 3, 224, 224)
    # The layers are the given weights' own: conv1 of a nonzero image.
    x = torch.ones_like(inputs[0])
    assert torch.equal(fns[0][1](x), TA.layer_fns(tp)[0][1](x))


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.init_b_alexnet(TA.BAlexNetConfig(), gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfig4.sweep(synthetic_costs(LayerCost))


# ------------------------------------------------------------- the sweeps
def synthetic_costs(cls, t_c=T_C, alpha=ALPHA):
    return [cls(n, 0.0, 0.0, a, t) for n, t, a in zip(NAMES, t_c, alpha)]


def reference_module(monkeypatch, name, t_c=T_C, alpha=ALPHA):
    """The reference's figure script with ``profile`` returning the
    synthetic costs."""
    monkeypatch.syspath_prepend(str(ROOT))
    mod = importlib.import_module(f"benchmarks.{name}")
    monkeypatch.setattr(mod, "profile", lambda: synthetic_costs(J.LayerCost, t_c, alpha))
    return mod


def float64_costs(p, gamma, bw, t_c=T_C, alpha=ALPHA):
    """E[T] of every split at one point, in float64."""
    f64 = torch.float64
    pv = torch.zeros(len(t_c) + 1, dtype=f64)
    pv[tfig4.BRANCH_AFTER] = float(p)
    tc = torch.tensor([0.0, *t_c], dtype=f64)
    al = torch.tensor([float(tprofile.RAW_INPUT_BYTES), *alpha], dtype=f64)
    return chain_costs_torch(tc, al, pv, gamma, bw).numpy()


def float32_ties(got, want, points, t_c=T_C, alpha=ALPHA):
    """Indices where the splits differ; each must be a tie at float32: the
    two splits' float64 costs within float32 rounding of each other.
    ``points[i]`` is (p, gamma, bandwidth) of index i."""
    diff = np.nonzero(got != want)[0].tolist()
    for i in diff:
        c = float64_costs(*points[i], t_c, alpha)
        gap = abs(c[want[i]] - c[got[i]]) / c[got[i]]
        assert c[got[i]] == c.min() and gap <= F32_TIE, (i, points[i], got[i], want[i], gap)
    return diff


def test_fig4_sweep_matches_reference(monkeypatch):
    ref = reference_module(monkeypatch, "fig4_inference_time")
    want = ref.sweep()
    got = tfig4.sweep(synthetic_costs(LayerCost), device="cpu")
    assert set(got) == set(want) and (tfig4.GAMMAS, tfig4.NETWORKS, tfig4.BRANCH_AFTER) == (
        ref.GAMMAS, ref.NETWORKS, ref.BRANCH_AFTER)
    ties = {}
    for (net, g), (ps, t, s) in got.items():
        wps, wt, ws = want[(net, g)]
        assert len(ps) == 101
        np.testing.assert_allclose(ps, wps, rtol=0, atol=1e-7)
        np.testing.assert_allclose(t, wt, rtol=1e-5)
        bw = J.UPLINK_PRESETS[net].bandwidth_bps
        ties[(net, g)] = float32_ties(s, ws, [(p, g, bw) for p in ps])
    # On this profile float32 resolves every point: the splits are equal.
    assert not any(ties.values()), ties
    rep_t, rep_j = tfig4.validate(got), ref.validate(want)
    assert rep_t.keys() == rep_j.keys()
    for k, v in rep_t.items():
        if isinstance(v, dict):
            assert v == pytest.approx(rep_j[k], abs=1e-3), k
        else:
            assert v == rep_j[k], k


def test_fig5_sweep_matches_reference(monkeypatch):
    ref = reference_module(monkeypatch, "fig5_partition_layer")
    want = ref.sweep()
    got = tfig5.sweep(synthetic_costs(LayerCost), device="cpu")
    assert set(got) == set(want) and tfig5.PROBS == ref.PROBS
    ties = {}
    for (net, p), (gammas, s) in got.items():
        wg, ws = want[(net, p)]
        assert len(gammas) == 60
        np.testing.assert_allclose(gammas, wg, rtol=1e-6)
        bw = J.UPLINK_PRESETS[net].bandwidth_bps
        ties[(net, p)] = float32_ties(s, ws, [(p, g, bw) for g in gammas])
    assert not any(ties.values()), ties
    assert sorted({int(x) for _, s in got.values() for x in s}) == [0, 1, 2, 5, 8]
    assert tfig5.validate(got) == ref.validate(want)


def test_a_float32_tie_is_the_one_allowed_difference(monkeypatch):
    """A profile whose edge-only cost lies 1e-9 of its value below
    cloud-only at 4G, gamma 10, p = 0 (every middle split ships 1 GB):
    float64 resolves the two, float32 does not.  The port picks the
    float64 optimum there, the reference (float32) the other split of the
    tie, and every other point agrees."""
    bw, g = J.UPLINK_PRESETS["4g"].bandwidth_bps, 10.0
    cloud = tprofile.RAW_INPUT_BYTES * 8 / bw  # + 8 t_c, t_c << this
    t_c = [cloud / (8 * g - 8) * (1 - 1e-9)] * 8
    alpha = [1e9] * 8
    c = float64_costs(0.0, g, bw, t_c, alpha)
    assert int(np.argmin(c)) == 8 and 0 < (c[0] - c[8]) / c[8] <= F32_TIE
    ref = reference_module(monkeypatch, "fig4_inference_time", t_c, alpha)
    want = ref.sweep()
    got = tfig4.sweep(synthetic_costs(LayerCost, t_c, alpha), device="cpu")
    assert got[("4g", g)][2][0] == 8
    ties = {key: float32_ties(s, want[key][2], [
        (p, key[1], J.UPLINK_PRESETS[key[0]].bandwidth_bps) for p in ps], t_c, alpha)
        for key, (ps, _, s) in got.items()}
    # float32 cannot tell the two apart: the reference takes split 0 there.
    assert ties == {key: [0] if key == ("4g", g) else [] for key in got}, ties
