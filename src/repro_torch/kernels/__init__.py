"""repro_torch.kernels — hand-written Hopper kernels of the serving path.

    csrc/flash_decode.cu  single-token GQA decode attention with the
                          survivor row map into the resident KV cache
    csrc/entropy_exit.cu  fused normalized-entropy + flag (+ argmax) exit
                          decision of K stacked branch heads
    csrc/ssd_scan.cu      Mamba2 SSD decode step against the resident
                          state (in place) and the prefill scan
    flash_decode.py,      ctypes launchers (device, dtype, shape checks;
    entropy_exit.py,      outputs allocated with torch.empty)
    ssd_scan.py
    build.py              nvcc -> build/kernels/*.so at first use
    ref.py                plain PyTorch versions
    ops.py                dispatch wrappers, launch counts, `use_kernels`

Importing this package loads no CUDA code and needs no toolkit.
"""
