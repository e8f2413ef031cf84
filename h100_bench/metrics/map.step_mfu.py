"""The whole mapping step's share of the card's fp32 peak: the operations
its mathematics needs (``counts/mapping_step.py``, per profiled step, with
the compositing kernels' counts from each launch's table), summed over the
profiled steps, over their wall time at 67 TFLOP/s (the configuration
computes in float32)."""


def read(ctx):
    st, work = ctx.get("stretch"), ctx.get("stretch_work")
    if not st or not work or not st["wall_s"]:
        return None
    ops = sum(w["step_ops"] for w in work)
    return ops / (st["wall_s"] * ctx["peaks"]["fp32_flops"]) * 100.0
