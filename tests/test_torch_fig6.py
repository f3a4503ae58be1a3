"""The port's Fig. 6 module (``repro_torch.benchmarks.fig6_calibration``)
against the reference's ``benchmarks/fig6_calibration.py`` on the CPU.

  * ``gaussian_blur`` at the paper's kernel sizes 5 / 15 / 65 on the same
    images (NHWC in the reference, NCHW in the port): within 1e-6 of the
    images' largest magnitude (the same shifted adds in the same order;
    the kernel's exponentials may differ in the last bit);
  * one plain SGD step of B-AlexNet (batch 2) on the reference's own
    weights and images (``train_b_alexnet(key, steps=1, batch=2)``): the
    loss to 1e-5 relative; the gradient each param moved by (new params
    rounded once to fp32, allowed for) within 1e-5 of its scale of the
    same step in float64, and within 1e-2 of the reference's (the
    reference's fp32 conv backward on the CPU lands up to 4e-3 of the
    scale off the float64 gradient, conv4's; the port within 1e-6);
  * ``make_images`` and ``run``'s rows: shapes, classes and the monotone
    curves (the port draws from a ``torch.Generator``, so the images are
    not the reference's).
"""

import importlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import alexnet as JA
from repro_torch import bridge
from repro_torch.benchmarks import fig6_calibration as tfig6

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small shapes: the test run's workers
    share the cores, and oversubscribed intra-op pools slowed this file's
    torch-only tests over 100x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
LR = 3e-4  # the reference's train_b_alexnet default


@pytest.fixture
def ref(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    return importlib.import_module("benchmarks.fig6_calibration")


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("ksize", sorted(tfig6.KERNELS.values()))
def test_gaussian_blur_matches_reference(ref, ksize):
    img = np.random.default_rng(ksize).standard_normal((2, 40, 36, 3)).astype(np.float32)
    want = np.asarray(jax.jit(ref.gaussian_blur, static_argnums=1)(img, ksize))
    got = tfig6.gaussian_blur(nchw(img), ksize).numpy().transpose(0, 2, 3, 1)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(img).max()


def test_sgd_step_matches_reference(ref):
    key = jax.random.PRNGKey(3)
    want, want_loss = ref.train_b_alexnet(key, steps=1, batch=2)
    img, lab = ref.make_images(jax.random.fold_in(key, 0), 2)
    jp = jax.tree.map(np.asarray, JA.init_b_alexnet(key))
    params = bridge.alexnet_params_from_jax(jp, "cpu")
    images, labels = nchw(img), torch.from_numpy(np.array(lab)).long()
    got, loss = tfig6.sgd_step(params, images, labels, LR)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    after = bridge.alexnet_params_from_jax(jax.tree.map(np.asarray, want), "cpu")
    p64 = {n: {k: t.double() for k, t in v.items()} for n, v in params.items()}
    got64, _ = tfig6.sgd_step(p64, images.double(), labels, LR)
    for name in params:
        for leaf in ("w", "b"):
            old = p64[name][leaf].numpy()
            g64, g_port, g_ref = ((old - t[name][leaf].double().numpy()) / LR
                                  for t in (got64, got, after))
            # Each new param is rounded once to fp32: ulp(old) / lr.
            rounding = 2.0 ** -23 * np.abs(old) / LR
            scale = np.abs(g64).max()
            assert (np.abs(g_port - g64) <= 1e-5 * scale + rounding).all(), (name, leaf)
            assert (np.abs(g_port - g_ref) <= 1e-2 * scale + rounding).all(), (name, leaf)


def test_make_images_classes():
    img, lab = tfig6.make_images(torch.Generator().manual_seed(0), 8, size=32)
    assert img.shape == (8, 3, 32, 32) and img.dtype == torch.float32
    assert lab.dtype == torch.int64 and set(lab.tolist()) <= {0, 1}
    for i in range(8):  # class 0 varies along the width, class 1 the height
        x = img[i, 0]
        along_w = float(x.mean(dim=0).std())
        along_h = float(x.mean(dim=1).std())
        assert (along_w > along_h) == (int(lab[i]) == 0)


def test_run_rows_and_monotone_curves(monkeypatch):
    """``run`` with a short training (2 steps of 4 images), 6 images per
    level: the reference's two rows; each curve monotone in the
    threshold."""
    train = tfig6.train_b_alexnet
    monkeypatch.setattr(tfig6, "train_b_alexnet", lambda g: train(g, steps=2, batch=4))
    rep = tfig6.report(n_eval=6, device="cpu")
    assert set(rep["curves"]) == {"low", "mid", "high"}
    for c in rep["curves"].values():
        assert c.shape == (20,) and np.all(np.diff(c) >= 0) and np.isfinite(c).all()
    rows = tfig6.run(n_eval=6, device="cpu")
    assert rows[0].startswith("fig6/train+sweep,") and "acc_low=" in rows[0]
    assert rows[1].startswith("fig6/claims,0.0,exit_prob_low>=mid>=high=")
    assert "monotone_in_threshold=True" in rows[1]
