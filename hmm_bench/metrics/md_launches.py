"""md_launches (launches/step): MD-layer kernel launches per macro-step, from
the port's launch counters (the fused run and force entries, the
multi-job run, the SW brick kernels); moves macro_step_s."""


def read(ctx):
    counts = ctx.get("launches")
    if counts is None or not ctx.get("steps"):
        return None
    return sum(counts.values()) / ctx["steps"]
