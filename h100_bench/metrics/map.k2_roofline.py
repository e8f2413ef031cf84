"""K2 (``csrc/composite_bwd.cu``, its two kernels together): the least time
its launches in the profiled stretch could take, by the frozen count of
``counts/rasterizer.py`` on each launch's own table and the published
peaks, over the time the profiler gives its kernels."""

from h100_bench import trace
from h100_bench.counts import rasterizer

KERNELS = ("chunk_totals_kernel", "chunk_grads_kernel")


def read(ctx):
    st, work = ctx.get("stretch"), ctx.get("stretch_work")
    if not st or not work:
        return None
    t = trace.kernel_seconds(st["by_name"], KERNELS)
    if t <= 0:
        return None
    b = sum(rasterizer.bound_ms(w["k2_ops"], w["k2_bytes"], ctx["peaks"])
            for w in work) / 1e3
    return b / t * 100.0
