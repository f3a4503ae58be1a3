"""The port's launch layer against the reference package, on the CPU.

* ``repro_torch.configs``: ``InputShape`` / ``INPUT_SHAPES``, ``all_configs``
  and the four param counts of all ten configs, at full size and at smoke
  size, as exact integers.
* ``repro_torch.launch.specs`` against ``repro.launch.specs`` for every
  arch x shape: ``shape_supported``, ``config_for_shape``'s sliding window,
  and every spec's shape and dtype against the reference's
  ``ShapeDtypeStruct`` and ``jax.eval_shape`` trees, path by path.
* ``launch.mesh.make_production_mesh`` on a fake process group of 256 and
  512 ranks, and its refusal at 8.
* ``launch.op_analysis.analyze_ops``: the counterparts of
  ``tests/test_hlo_analysis.py`` (a loop of 8 products, 5 x 8 nested, the
  bytes of 16 weight slices, one product with no collective), exact where
  the reference allows 1%; a product whose weight is ``Shard(0)`` over a
  fake 4-rank ``model`` axis, made whole: this rank's FLOPs and one
  all-reduce of the result; an explicit ``dist.all_reduce``; and the smoke
  ``qwen3_8b`` and ``phi3_mini_3_8b`` prefill (B = 2, T = 32, cache 64)
  within 1% of ``repro.launch.hlo_analysis.analyze_hlo`` on the
  reference's jitted prefill of the same shapes (no contraction differs
  between the packages: the counts are equal).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import all_configs as j_all_configs
from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.launch import specs as JS
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import model as JM
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, InputShape, all_configs, get_config
from repro_torch.configs import get_smoke_config
from repro_torch.launch import specs as TS
from repro_torch.launch.mesh import fake_process_group, make_local_mesh, make_production_mesh
from repro_torch.launch.op_analysis import COLLECTIVES, analyze_ops
from repro_torch.models import model as TM
from repro_torch.sharding.policy import tree_paths

COUNTS = ("attn_matmul_params", "dense_mlp_matmul_params", "num_params", "active_params")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small shapes: the test run's workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_paths(tree) -> dict:
    """path -> (shape, dtype name) of a JAX tree (keys joined with '/')."""
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        out[path] = (tuple(leaf.shape), jnp.dtype(leaf.dtype).name)
    return out


def _torch_paths(tree) -> dict:
    out = {}
    for path, t in tree_paths(tree):
        assert t.device.type == "meta", path
        out[path] = (tuple(t.shape), str(t.dtype).removeprefix("torch."))
    return out


# ------------------------------------------------------------------ configs
def test_input_shapes_equal_the_reference():
    assert list(INPUT_SHAPES) == list(J_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        ref = J_SHAPES[name]
        assert isinstance(shape, InputShape)
        assert dataclasses.asdict(shape) == dataclasses.asdict(ref)
        assert shape.is_decode == ref.is_decode
    with pytest.raises(dataclasses.FrozenInstanceError):
        INPUT_SHAPES["train_4k"].seq_len = 1


def test_all_configs_are_the_reference_configs():
    ours = {c.name: dataclasses.asdict(c) for c in all_configs()}
    theirs = {c.name: dataclasses.asdict(c) for c in j_all_configs()}
    assert ours == theirs and len(ours) == len(ARCH_IDS) == 10


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_equal_the_reference(arch, size):
    ours = get_config(arch) if size == "full" else get_smoke_config(arch)
    theirs = j_config(arch) if size == "full" else j_smoke(arch)
    for name in COUNTS:
        got, want = getattr(ours, name)(), getattr(theirs, name)()
        assert isinstance(got, int) and got == want, (name, got, want)


# ------------------------------------------------------------------ specs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference(arch):
    """Every input shape: support and its reason, the shape's config
    variant, and every spec tree path by path (shape and dtype)."""
    cfg, jcfg = get_config(arch), j_config(arch)
    assert _torch_paths(TS.param_specs(cfg)) == _jax_paths(JS.param_specs(jcfg))
    for name, shape in INPUT_SHAPES.items():
        jshape = J_SHAPES[name]
        assert TS.shape_supported(cfg, shape) == JS.shape_supported(jcfg, jshape)
        if not TS.shape_supported(cfg, shape)[0]:
            continue
        c, jc = TS.config_for_shape(cfg, shape), JS.config_for_shape(jcfg, jshape)
        assert c.sliding_window == jc.sliding_window
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
        for fn in ("train_batch_specs", "prefill_input_specs", "decode_input_specs",
                   "cache_specs"):
            assert (_torch_paths(getattr(TS, fn)(c, shape))
                    == _jax_paths(getattr(JS, fn)(jc, jshape))), (arch, name, fn)
    assert TS.LONG_CONTEXT_WINDOW == JS.LONG_CONTEXT_WINDOW


def test_long_context_variant_and_whisper_skip():
    long = INPUT_SHAPES["long_500k"]
    ok, why = TS.shape_supported(get_config("whisper_medium"), long)
    assert not ok and "1500" in why
    assert TS.config_for_shape(get_config("qwen3_8b"), long).sliding_window == 8192
    assert TS.config_for_shape(get_config("mamba2_130m"), long).sliding_window == 0
    vlm = get_config("internvl2_76b")
    spec = TS.prefill_input_specs(vlm, INPUT_SHAPES["prefill_32k"])
    assert spec["tokens"].shape == (32, 32_768 - vlm.num_patches)
    assert spec["patch_embeds"].shape == (32, vlm.num_patches, vlm.d_model)


# ------------------------------------------------------------------ mesh
@pytest.mark.parametrize("world,multi_pod,shape,names", [
    (256, False, (16, 16), ("data", "model")),
    (512, True, (2, 16, 16), ("pod", "data", "model")),
])
def test_production_mesh_on_a_fake_group(world, multi_pod, shape, names):
    with fake_process_group(world):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == names
        assert dist.get_world_size() == world and dist.get_rank() == 0
    assert not dist.is_initialized()


def test_production_mesh_refuses_another_world():
    with fake_process_group(8):
        with pytest.raises(ValueError, match="256.*512.*8"):
            make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="512"):
            make_production_mesh(multi_pod=True, device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        make_production_mesh(device="cpu")


# ------------------------------------------------------------ op analysis
def _chain(w, x):
    for i in range(w.shape[0]):
        x = torch.tanh(x @ w[i])
    return x


def test_loop_of_products_counts_every_trip():
    """tests/test_hlo_analysis.py::test_scan_matches_unrolled."""
    w, x = torch.randn(8, 256, 256), torch.randn(4, 256)
    r = analyze_ops(_chain, w, x)
    assert r["dot_flops"] == 2 * 8 * 4 * 256 * 256
    assert all(v == 0 for v in r["collectives"].values())


def test_nested_loops_multiply():
    """tests/test_hlo_analysis.py::test_nested_scans_multiply."""
    w, x = torch.randn(8, 128, 128), torch.randn(4, 128)

    def nested(w, x):
        for _ in range(5):
            x = _chain(w, x)
        return x

    assert analyze_ops(nested, w, x)["dot_flops"] == 5 * 8 * 2 * 4 * 128 * 128


def test_bytes_scale_with_trip_count():
    """tests/test_hlo_analysis.py::test_bytes_scale_with_trip_count.  The
    reference's scan copies each weight slice out (a ``dynamic-slice``,
    whose result its proxy counts); with that copy here (``clone``) the
    proxy is >= 16 x 64 KB and doubles with the trip count.  Read through
    views instead, the 16 slices stream under ``hbm_argument_bytes`` and
    the proxy counts the results alone."""
    x = torch.randn(4, 128)

    def copied(w, x):
        for i in range(w.shape[0]):
            x = torch.tanh(x @ w[i].clone())
        return x

    b = {n: analyze_ops(copied, torch.randn(n, 128, 128), x)["hbm_bytes"] for n in (8, 16)}
    assert b[16] >= 16 * 128 * 128 * 4
    # 2 x every result: per trip the slice, the product and its tanh
    assert b[16] == 16 * 2 * (128 * 128 + 2 * 4 * 128) * 4 == 2 * b[8]
    r = analyze_ops(_chain, torch.randn(16, 128, 128), x)
    assert r["hbm_argument_bytes"] >= 16 * 128 * 128 * 4
    assert r["hbm_bytes"] == 16 * 2 * (2 * 4 * 128) * 4


def test_no_loops_ok():
    """tests/test_hlo_analysis.py::test_no_loops_ok."""
    a = torch.randn(32, 32)
    r = analyze_ops(lambda a: a @ a, a)
    assert r["dot_flops"] == 2 * 32 ** 3
    assert all(v == 0 for v in r["collectives"].values())
    assert set(r["collectives"]) == set(COLLECTIVES) == set(r["counts"])
    assert r["output_bytes"] == 32 * 32 * 4


def test_views_move_nothing_and_slice_updates_count_the_update():
    x = torch.randn(64, 64)
    r = analyze_ops(lambda x: (x.t(), x.view(-1), x[3:5], x.detach(), x.unsqueeze(0)), x)
    assert r["hbm_bytes"] == 0 and r["dot_flops"] == 0
    buf, upd = torch.zeros(64, 64), torch.ones(2, 64)
    idx = torch.tensor([1, 5])
    r = analyze_ops(lambda: buf.index_copy_(0, idx, upd))
    assert r["hbm_bytes"] == 2 * upd.numel() * 4
    r = analyze_ops(lambda: buf[2:4].copy_(upd))
    assert r["hbm_bytes"] == 2 * upd.numel() * 4


def test_sharded_product_counts_this_rank_and_its_collective():
    """A fp32 (8, 64) x (64, 64) product, the weight Shard(0) over a fake
    4-rank model axis: this rank multiplies its (8, 16) x (16, 64) block,
    then the partial result is made whole by one all-reduce of 8 x 64 x 4
    bytes.  An explicit ``dist.all_reduce`` is counted too."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    with fake_process_group(4):
        mesh = make_local_mesh(data=1, model=4, device="cpu")
        x, w = torch.randn(8, 64), torch.randn(64, 64)
        wd = distribute_tensor(w, mesh, [Replicate(), Shard(0)])
        xd = DTensor.from_local(x, mesh, [Replicate(), Replicate()], run_check=False)
        whole = [Replicate(), Replicate()]
        r = analyze_ops(lambda: (xd @ wd).redistribute(mesh, whole))
        assert r["dot_flops"] == 2 * 8 * 16 * 64
        assert r["collectives"]["all-reduce"] == 8 * 64 * 4
        assert r["counts"] == {**{c: 0 for c in COLLECTIVES}, "all-reduce": 1}
        assert tuple(r["out"].to_local().shape) == (8, 64)
        r = analyze_ops(lambda: dist.all_reduce(x))
        assert r["collectives"]["all-reduce"] == 8 * 64 * 4
        assert r["counts"]["all-reduce"] == 1
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ["qwen3_8b", "phi3_mini_3_8b"])
def test_prefill_dot_flops_match_the_reference(arch):
    """The smoke prefill (B = 2, T = 32, cache 64): the port's eager count
    within 1% of ``analyze_hlo`` on the reference's jitted prefill (the
    reference's scratch run: 147,324,928 and 172,490,752)."""
    jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
    jparams = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jcfg))
    jcaches = jax.eval_shape(lambda: JM.init_caches(jcfg, 2, 64))
    toks = jax.ShapeDtypeStruct((2, 32), jnp.int32)
    hlo = (jax.jit(lambda p, t, c: JM.prefill(p, {"tokens": t}, jcfg, c))
           .lower(jparams, toks, jcaches).compile().as_text())
    want = analyze_hlo(hlo)["dot_flops"]
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    caches = TM.init_caches(cfg, 2, 64, device="cpu")
    tokens = torch.from_numpy(np.zeros((2, 32), np.int32))
    got = analyze_ops(TM.prefill, params, tokens, cfg, caches)["dot_flops"]
    assert got == pytest.approx(want, rel=0.01)
    assert want == {"qwen3_8b": 147_324_928, "phi3_mini_3_8b": 172_490_752}[arch]
