"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W limit): the roofline's ceilings."""

H100_SXM = {
    "bf16_flops": 989e12,
    "hbm_bytes_per_s": 3.35e12,
}
