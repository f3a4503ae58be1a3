"""Device milliseconds of admission per thousand prompt tokens: CUDA
events the harness records around every ``TierExecutor.prefill_rows``
call in the window, over the prompt tokens those calls admitted.  Moves
``ttft_p95_ms``."""


def read(run):
    ms = sum(t for t, _ in run.prefill_ms)
    tokens = sum(n for _, n in run.prefill_ms)
    return ms / (tokens / 1e3) if tokens else None
