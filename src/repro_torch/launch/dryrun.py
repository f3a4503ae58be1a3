"""Dry run of every (architecture x input shape) on the production meshes —
counterpart of ``repro.launch.dryrun``.

Nothing is computed and nothing is allocated on any device.  Inside a fake
process group of 256 (or 512) ranks, with this process as rank 0
(:func:`~repro_torch.launch.mesh.fake_process_group`), the params, the
optimizer state, the caches and the batch are DTensors whose local shards
are ``meta`` tensors (a shape and a dtype, no storage), placed by the
ported policy (``param_spec``, ``opt_state_shardings``, ``cache_spec``,
``data_spec``).  Every op on them runs on ``meta`` shards, and the fake
group's collectives move nothing.  (Not ``FakeTensorMode``: torch 2.13's
strided-shard metadata reads index tensors, which a fake mode leaves
without data.)
The train, prefill or decode step then runs once, eagerly, under
:func:`~repro_torch.sharding.ctx.activation_sharding` and
:func:`~repro_torch.launch.op_analysis.analyze_ops`, which records this
rank's matmul FLOPs, HBM-bytes proxy and collective bytes, and the peak of
the live bytes of the storages the step makes.

The record's ``memory``:

  * ``argument_bytes``: this rank's local bytes of the step's inputs (the
    params, or the whole train state; the batch; the caches);
  * ``output_bytes``: the bytes of the outputs the step made (a decode or
    prefill step updates its caches in place, so only its logits);
  * ``peak_bytes_est``: ``argument_bytes`` plus the peak of the live bytes
    the step made.  It is an eager peak, what this rank would hold running
    the port's step op by op, not a compiled program's: nothing is fused
    or donated, so a train step holds its old and new state together.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                 # everything
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_8b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod     # 2x16x16
    ... --force     re-run combinations that already have a record

Records land in ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.configs import get_config
from repro_torch.launch.mesh import fake_process_group, make_production_mesh, mesh_axis_sizes
from repro_torch.launch.op_analysis import analyze_ops
from repro_torch.launch.specs import (
    cache_specs,
    config_for_shape,
    decode_input_specs,
    param_specs,
    prefill_input_specs,
    shape_supported,
    train_batch_specs,
)
from repro_torch.sharding.ctx import mesh_context
from repro_torch.sharding.policy import (
    _map_paths,
    make_policy,
    placements,
    spec_at,
    tree_paths,
)

__all__ = ["RESULTS_DIR", "build_step", "run_one", "main", "place", "local_bytes"]

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


# ---------------------------------------------------------------------------
def place(shape_tree, mesh, spec_of):
    """Every leaf of ``shape_tree`` (tensors with a shape and dtype) as a
    DTensor on ``mesh`` placed by ``spec_of(path, leaf)``, its local shard
    an empty ``meta`` tensor of the shard's shape.  The policy shards a
    dim only where the mesh axes divide it."""
    from torch.distributed.tensor import DTensor, Shard

    sizes = list(mesh_axis_sizes(mesh).values())

    def one(path, leaf):
        pl = placements(spec_of(path, leaf), mesh)
        local = list(leaf.shape)
        for size, p in zip(sizes, pl):
            if isinstance(p, Shard):
                assert local[p.dim] % size == 0, (path, tuple(leaf.shape), pl)
                local[p.dim] //= size
        t = torch.empty(local, dtype=leaf.dtype, device="meta")
        return DTensor.from_local(t, mesh, pl, run_check=False)

    return _map_paths(one, shape_tree)


def local_bytes(tree) -> int:
    """This rank's bytes of every tensor leaf (a DTensor's local shard)."""
    from repro_torch.sharding.ctx import local

    return sum(local(t).numel() * t.element_size()
               for _, t in tree_paths(tree) if isinstance(t, torch.Tensor))


def _batch_shards(mesh) -> int:
    axes = mesh_axis_sizes(mesh)
    return math.prod(axes[a] for a in ("pod", "data") if a in axes)


def build_step(cfg: ModelConfig, shape: InputShape, mesh, moe_dispatch: str):
    """(step fn, its placed args tuple) for this workload kind: DTensors
    over ``meta`` shards, so nothing is allocated.  Call it inside a
    process group (the fake one) that ``mesh`` spans."""
    from repro_torch.models import model as M

    policy = make_policy(mesh, cfg)
    p_shapes = param_specs(cfg)
    params = place(p_shapes, mesh, lambda p, t: policy.param_spec(p, tuple(t.shape)))

    def data(tree):
        return place(tree, mesh, lambda p, t: policy.data_spec(tuple(t.shape)))

    if shape.kind == "train":
        from repro_torch.training.optimizer import make_optimizer
        from repro_torch.training.train_loop import make_train_step

        opt = make_optimizer(cfg.optimizer)
        # Cap accumulation so each microbatch covers all batch shards.
        accum = max(1, min(cfg.grad_accum, shape.global_batch // _batch_shards(mesh)))
        step_fn = make_train_step(cfg, opt, moe_dispatch=moe_dispatch, accum=accum)
        opt_specs = policy.opt_state_shardings(p_shapes, cfg.optimizer)
        opt_state = place(opt.init(p_shapes), mesh, lambda p, t: spec_at(opt_specs, p))
        step = torch.zeros((), dtype=torch.int32, device="meta")
        state = {"params": params, "opt": opt_state, "step": step}
        return step_fn, (state, data(train_batch_specs(cfg, shape)))

    caches = place(cache_specs(cfg, shape), mesh,
                   lambda p, t: policy.cache_spec(p, tuple(t.shape)))
    if shape.kind == "prefill":
        inputs = data(prefill_input_specs(cfg, shape))
        tokens = inputs.pop("tokens")

        def prefill(params, tokens, inputs, caches):
            return M.prefill(params, tokens, cfg, caches, moe_dispatch=moe_dispatch,
                             **inputs)

        return prefill, (params, tokens, inputs, caches)

    io = decode_input_specs(cfg, shape)
    token = data({"t": io["token"]})["t"]
    pos = torch.full((), shape.seq_len - 1, dtype=torch.int32, device="meta")

    def decode(params, token, pos, caches):
        return M.decode_step(params, token, pos, caches, cfg, moe_dispatch=moe_dispatch,
                             use_kernels=False)

    return decode, (params, token, pos, caches)


def run_one(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    moe_dispatch: str = "einsum",
    out_dir: Path = RESULTS_DIR,
    force: bool = False,
    tag: str = "",
    overrides: dict | None = None,
    *,
    cfg: ModelConfig | None = None,
    mesh_shape: tuple[int, ...] | None = None,
) -> dict:
    """One record (see the module doc), written to ``out_dir`` (None: not
    written).  ``cfg`` replaces the published config (a smoke config in
    the tests) and ``mesh_shape`` the production mesh: a ``("data",
    "model")`` mesh, or ``("pod", "data", "model")`` with three dims."""
    if mesh_shape is None:
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    else:
        mesh_name = "x".join(map(str, mesh_shape))
    suffix = f"__{tag}" if tag else ""
    out_path = None if out_dir is None else (
        Path(out_dir) / f"{arch}__{shape_name}__{mesh_name}{suffix}.json")
    if out_path is not None and out_path.exists() and not force:
        return json.loads(out_path.read_text())

    shape = INPUT_SHAPES[shape_name]
    cfg0 = cfg if cfg is not None else get_config(arch)
    ok, why = shape_supported(cfg0, shape)
    rec: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "kind": shape.kind,
        "moe_dispatch": moe_dispatch,
        "tag": tag,
    }
    if not ok:
        rec.update(status="skipped", reason=why)
        _write(out_path, rec)
        return rec

    cfg = config_for_shape(cfg0, shape)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
        rec["overrides"] = {k: str(v) for k, v in overrides.items()}
    try:
        rec.update(_trace(cfg, shape, multi_pod, mesh_shape, moe_dispatch))
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
    _write(out_path, rec)
    return rec


def _trace(cfg: ModelConfig, shape: InputShape, multi_pod: bool,
           mesh_shape: tuple[int, ...] | None, moe_dispatch: str) -> dict:
    from repro_torch.launch.mesh import make_local_mesh

    world = math.prod(mesh_shape) if mesh_shape else (512 if multi_pod else 256)
    with fake_process_group(world):
        if mesh_shape is None:
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        elif len(mesh_shape) == 2:
            mesh = make_local_mesh(data=mesh_shape[0], model=mesh_shape[1], device="cpu")
        else:
            from torch.distributed.device_mesh import init_device_mesh

            mesh = init_device_mesh("cpu", tuple(mesh_shape),
                                    mesh_dim_names=("pod", "data", "model"))
        return _traced(cfg, shape, mesh, moe_dispatch)


def _traced(cfg: ModelConfig, shape: InputShape, mesh, moe_dispatch: str) -> dict:
    """The step traced once under the context a sharded segment runs in:
    the activation-sharding context, plain tensors meeting DTensors counted
    as replicated."""
    t0 = time.perf_counter()
    fn, args = build_step(cfg, shape, mesh, moe_dispatch)
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh_axis_sizes(mesh))
    with mesh_context(mesh, batch_axes):
        stats = analyze_ops(fn, *args)
    trace_s = time.perf_counter() - t0
    arg_bytes = local_bytes(args)
    param_bytes = local_bytes(args[0]["params"] if shape.kind == "train" else args[0])
    del args, stats["out"]
    return dict(
        status="ok",
        trace_s=round(trace_s, 2),
        memory={
            "argument_bytes": arg_bytes,
            "param_bytes": param_bytes,
            "output_bytes": stats["output_bytes"],
            "peak_bytes_est": arg_bytes + stats["peak_live_bytes"],
        },
        dot_flops=stats["dot_flops"],
        hbm_bytes=stats["hbm_bytes"],
        hbm_argument_bytes=stats["hbm_argument_bytes"],
        collectives={**stats["collectives"], "_counts": stats["counts"]},
        num_params=cfg.num_params(),
        active_params=cfg.active_params(),
        sliding_window=cfg.sliding_window,
    )


def _write(path: Path | None, rec: dict) -> None:
    if path is None:
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=2, default=str))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--moe-dispatch", default="einsum",
                    choices=["einsum", "onehot_small"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="suffix for experiment variants")
    ap.add_argument("--set", action="append", default=[],
                    help="config override field=value (perf experiments)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        if v in ("true", "True"):
            v = True
        elif v in ("false", "False"):
            v = False
        elif v.isdigit():
            v = int(v)
        overrides[k] = v

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_ok = n_err = n_skip = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_one(arch, shape, mp, args.moe_dispatch, out_dir=RESULTS_DIR,
                              force=args.force, tag=args.tag,
                              overrides=overrides or None)
                status = rec["status"]
                n_ok += status == "ok"
                n_err += status == "error"
                n_skip += status == "skipped"
                mem = rec.get("memory", {}).get("peak_bytes_est")
                mem_s = f"{mem / 1e9:.2f} GB/dev" if mem else "-"
                print(
                    f"[{status:7s}] {arch:20s} {shape:12s} "
                    f"{'2x16x16' if mp else '16x16':8s} {mem_s}"
                    + (f"  ERR: {rec.get('error', '')[:120]}" if status == "error" else ""),
                    flush=True)
    print(f"\nok={n_ok} skipped={n_skip} errors={n_err}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
