"""B-AlexNet per-layer cost profile — the shared input of the Fig. 4 / 5
sweeps.  Counterpart of ``benchmarks/alexnet_profile.py``.

The paper measures t_i^c on Google Colab (K80); :func:`profile` measures
the same chain on the given device in measure mode (on the card, CUDA-graph
replays of each layer).  alpha_i is each layer's output size, the quantity
that crosses the edge -> cloud uplink.  Nothing is cached: the reference's
``results/alexnet_profile.json`` belongs to the JAX package.

    python -m repro_torch.benchmarks.alexnet_profile [--device cpu] [--out build/alexnet_profile.json]

prints the profile (and with ``--out`` writes it as JSON, the
``--profile`` input of the figure modules).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from repro_torch.core import LayerCost, measure_layer_times
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.alexnet import BAlexNetConfig, init_b_alexnet, layer_fns

__all__ = ["RAW_INPUT_BYTES", "BRANCH_AFTER", "profile", "chain_arrays", "load",
           "costs_from_args"]

#: Raw 224x224x3 fp32 image — the paper's alpha_0 (cloud-only upload).
RAW_INPUT_BYTES = 224 * 224 * 3 * 4
#: The paper's single side branch, after conv1.
BRANCH_AFTER = 1


def profile(device=None, params=None) -> list[LayerCost]:
    """Measure-mode costs of B-AlexNet's 8 layers at batch 1, 3 warmup
    calls and 20 timed calls (on the card: graph replays) per layer, as
    the reference times them; each layer is fed zeros of its input's shape
    as the reference chains them.  ``params``: the weights to time (their
    device is used); default random weights from seed 0 on ``device``
    (default: the current CUDA device)."""
    if params is None:
        device = resolve_device(device)
        params = init_b_alexnet(BAlexNetConfig(),
                                torch.Generator(device=device).manual_seed(0), device)
    else:
        device = params["conv1"]["w"].device
    fns = layer_fns(params)
    x = torch.zeros((1, 3, 224, 224), device=device)
    inputs = []
    for _, fn in fns:
        inputs.append(x)
        x = torch.zeros_like(fn(x))
    return measure_layer_times(fns, inputs, iters=20, warmup=3)


def chain_arrays(costs, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(t_c, alpha) of the chain as float64 tensors on ``device``, slot 0
    the input (t_c 0, alpha the raw image)."""
    t_c = [0.0] + [c.time_s for c in costs]
    alpha = [float(RAW_INPUT_BYTES)] + [c.output_bytes for c in costs]
    return (torch.tensor(t_c, dtype=torch.float64, device=device),
            torch.tensor(alpha, dtype=torch.float64, device=device))


def load(path) -> list[LayerCost]:
    """A profile written by ``--out`` (the reference's cache format)."""
    return [LayerCost(**row) for row in json.loads(Path(path).read_text())]


def costs_from_args(description: str, argv=None) -> tuple[list[LayerCost], str | None]:
    """The figure modules' command line: (the profile, the device to
    solve on).  ``--profile PATH`` loads a saved profile, else B-AlexNet
    is profiled now on ``--device``."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", default=None,
                        help="cpu, or a CUDA device (default: the current one)")
    parser.add_argument("--profile", type=Path, default=None,
                        help="a profile JSON written by repro_torch.benchmarks."
                        "alexnet_profile --out (default: profile B-AlexNet now "
                        "on --device)")
    args = parser.parse_args(argv)
    costs = load(args.profile) if args.profile else profile(args.device)
    return costs, args.device


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cpu, or a CUDA device (default: the current one)")
    parser.add_argument("--out", type=Path, default=None,
                        help="also write the profile here as JSON")
    args = parser.parse_args(argv)
    costs = profile(args.device)
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for c in costs:
        print(f"alexnet/{c.name},{c.time_s * 1e6:.3f},alpha={c.output_bytes:g};device={where}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps([dataclasses.asdict(c) for c in costs]))


if __name__ == "__main__":
    main()
